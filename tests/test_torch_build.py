"""The port's kernel build cache (``hifigan_tpu_torch/ops/_build.py``): a
library is named by a hash of its source and of every header the source
includes, so an edited header rebuilds every library that includes it and
no other. No ``nvcc`` is needed: only the library paths are computed."""

from hifigan_tpu_torch.ops import _build


def _tiny_csrc(root):
    csrc = root / "csrc"
    csrc.mkdir()
    (csrc / "core.cuh").write_text('#pragma once\n#include "detail.cuh"\nint core();\n')
    (csrc / "detail.cuh").write_text("#pragma once\n// detail\n")
    (csrc / "a.cu").write_text('#include "core.cuh"\nextern "C" int a() { return 0; }\n')
    (csrc / "b.cu").write_text('#include  "core.cuh"\nextern "C" int b() { return 1; }\n')
    (csrc / "c.cu").write_text('#include <cuda_runtime.h>\nextern "C" int c() { return 2; }\n')
    return csrc


def test_library_path_follows_every_included_header(tmp_path):
    csrc = _tiny_csrc(tmp_path)
    paths = lambda: {n: _build._lib_path(csrc / f"{n}.cu") for n in "abc"}  # noqa: E731
    before = paths()
    assert paths() == before  # unchanged sources: the same libraries
    assert len(set(before.values())) == 3
    (csrc / "detail.cuh").write_text("#pragma once\n// detail, edited\n")  # included through core.cuh
    after = paths()
    assert after["a"] != before["a"] and after["b"] != before["b"]
    assert after["c"] == before["c"]
    (csrc / "core.cuh").write_text('#pragma once\n#include "detail.cuh"\nint core(int);\n')
    again = paths()
    assert again["a"] != after["a"] and again["b"] != after["b"] and again["c"] == after["c"]
    (csrc / "a.cu").write_text('#include "core.cuh"\nextern "C" int a() { return 3; }\n')
    last = paths()
    assert last["a"] != again["a"] and last["b"] == again["b"]


def test_the_conv_kernels_hash_the_shared_core():
    for name in ("conv_stack", "msd_conv", "resblock_tail"):
        assert [p.name for p in _build._sources(_build.CSRC / f"{name}.cu")] == [
            f"{name}.cu", "conv_core.cuh"]
    assert [p.name for p in _build._sources(_build.CSRC / "logmel.cu")] == [
        "logmel.cu", "conv_core.cuh", "logmel_plan.cuh"]
    assert [p.name for p in _build._sources(_build.CSRC / "stream_graph.cu")] == [
        "stream_graph.cu"]
