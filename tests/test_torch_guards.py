"""Guards of the PyTorch port: what it imports, where it runs, no fallback."""

import ast
import inspect
import os
import textwrap

import pytest
import torch

from hifigan_tpu_torch.cli import infer
from hifigan_tpu_torch.models.fast_infer import make_fast_vocoder
from hifigan_tpu_torch.ops import resblock_tail as ttail
from tests.torch_port_helpers import folded_pair, small_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "hifigan_tpu")


def _port_files():
    root = os.path.join(REPO, "hifigan_tpu_torch")
    for dirpath, _, names in os.walk(root):
        for n in names:
            if n.endswith(".py"):
                yield os.path.join(dirpath, n)
    yield os.path.join(REPO, "chip_smoke.py")


def _imported_modules(path):
    tree = ast.parse(open(path, encoding="utf-8").read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    """An AST scan: the environment may import jax at interpreter start-up,
    so sys.modules proves nothing."""
    files = list(_port_files())
    assert len(files) > 15
    bad = [(os.path.relpath(f, REPO), m) for f in files for m in _imported_modules(f)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_entry_points_without_device_raise_when_there_is_no_gpu(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    h = small_config("1")
    _, sd = folded_pair(h)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_fast_vocoder(h, sd)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        infer.inference(infer.build_parser().parse_args(
            ["--checkpoint_file", str(tmp_path / "g_00000000")]), h)


def test_wrapper_takes_plain_version_only_for_cpu_tensors(monkeypatch):
    h = small_config("1")
    _, sd = folded_pair(h)
    packed = ttail.pack_generator_tail(h, sd, 1)
    calls = []
    monkeypatch.setattr(ttail, "fused_tail_stage_reference",
                        lambda x, p, post_pack=None: calls.append(x.device) or x)
    launches = ttail.LAUNCHES
    ttail.fused_tail_stage(torch.zeros(1, 16, 8), packed)
    assert calls == [torch.device("cpu")] and ttail.LAUNCHES == launches
    with pytest.raises(ValueError):
        ttail.fused_tail_stage(torch.zeros(1, 16, 8, device="meta"), packed)
    assert len(calls) == 1


def test_wrapper_has_no_fallback():
    """The CUDA branch launches or raises: no try/except in the wrapper."""
    tree = ast.parse(textwrap.dedent(inspect.getsource(ttail.fused_tail_stage)))
    assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))
