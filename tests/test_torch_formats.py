"""The port's own readers and writers of the JAX side's formats, on the
CPU: flax msgpack (``train/msgpack.py``), the YAML ``yaml.dump`` writes
(``utils/caching.py``), the checkpoint dispatch and torch interchange names
(``train/checkpoint.py``) and the nested-structure helpers
(``utils/pytree.py``), each against the library or JAX function."""

import os

import jax
import ml_dtypes
import numpy as np
import pytest
import torch
import yaml
from flax import serialization

from hifigan_tpu.train import checkpoint as jckpt
from hifigan_tpu.utils import pytree as jpytree
from hifigan_tpu_torch.train import checkpoint as tckpt
from hifigan_tpu_torch.train import msgpack as tmsgpack
from hifigan_tpu_torch.utils import caching, pytree
from tests.torch_port_helpers import jax_params, small_config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tree():
    rng = np.random.default_rng(0)
    return {"step": 7, "name": "distill/production", "neg": -300, "big": 2 ** 40, "f": 0.25,
            "flag": True, "none": None, "list": [1, "a", 2.5],
            "variables": {"encoder": {"params": {
                "m_0_conv": {"v": rng.standard_normal((3, 1, 4)).astype(np.float32),
                             "g": rng.standard_normal(4).astype(np.float32)},
                "m_1_conv": {"kernel": rng.standard_normal((3, 4, 4)).astype(np.float32),
                             "bias": np.arange(4, dtype=np.int32)}}},
                "z": {"counts": np.arange(40, dtype=np.int64).reshape(5, 8), "e": {}}},
            "long_text": "x" * 300, "many": {f"k{i}": i for i in range(20)}}


def _assert_same(a, b):
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b)
        for k in a:
            _assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y)
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    else:
        assert type(a) is type(b) and (a == b or (a != a and b != b)), (a, b)


def test_msgpack_writes_flax_bytes_and_reads_them():
    tree = _tree()
    ours = tmsgpack.msgpack_serialize(tree)
    assert ours == serialization.msgpack_serialize(tree)
    _assert_same(serialization.msgpack_restore(ours), tmsgpack.msgpack_restore(ours))
    # torch tensors are written as the arrays they hold
    assert tmsgpack.msgpack_serialize({"w": torch.arange(6.0).reshape(2, 3)}) == \
        serialization.msgpack_serialize({"w": np.arange(6.0, dtype=np.float32).reshape(2, 3)})


def test_msgpack_scalars_complex_and_bfloat16():
    tree = {"s": np.float32(1.5), "i": np.int64(-3), "c": complex(1.0, -2.0),
            "h": np.arange(6, dtype=np.float16).reshape(2, 3)}
    ours = tmsgpack.msgpack_serialize(tree)
    assert ours == serialization.msgpack_serialize(tree)
    back = tmsgpack.msgpack_restore(ours)
    assert back["s"] == np.float32(1.5) and back["s"].dtype == np.float32
    assert back["i"] == -3 and back["c"] == complex(1.0, -2.0)
    bf = (np.arange(12, dtype=np.float32) / 7).astype(ml_dtypes.bfloat16).reshape(3, 4)
    data = serialization.msgpack_serialize({"w": bf})
    got = tmsgpack.msgpack_restore(data)["w"]
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (3, 4)
    np.testing.assert_array_equal(got.float().numpy(), bf.astype(np.float32))
    assert tmsgpack.msgpack_serialize({"w": got}) == data


def test_msgpack_chunks_large_arrays_as_flax_does(monkeypatch):
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(tmsgpack, "MAX_CHUNK_SIZE", 64)
    tree = {"a": np.arange(50, dtype=np.float32).reshape(5, 10), "b": {"c": np.ones(3)}}
    ours = tmsgpack.msgpack_serialize(tree)
    assert ours == serialization.msgpack_serialize(tree)
    _assert_same(tmsgpack.msgpack_restore(ours), serialization.msgpack_restore(ours))
    np.testing.assert_array_equal(tmsgpack.msgpack_restore(ours)["a"], tree["a"])


def test_msgpack_refuses_trailing_or_unknown_data():
    with pytest.raises(ValueError):
        tmsgpack.msgpack_restore(tmsgpack.msgpack_serialize({"a": 1}) + b"\x00")
    with pytest.raises(ValueError):
        tmsgpack.msgpack_restore(b"\xc1")
    with pytest.raises(TypeError):
        tmsgpack.msgpack_serialize({"a": object()})


def test_load_checkpoint_dispatches_as_jax(tmp_path):
    tree = {"step": 3, "variables": {"w": np.ones((2, 2), np.float32)}}
    (tmp_path / "latest").write_bytes(serialization.msgpack_serialize(tree))
    _assert_same(tckpt.load_checkpoint(str(tmp_path / "latest")),
                 jckpt.load_checkpoint(str(tmp_path / "latest")))
    torch.save({"generator": {"w": torch.ones(2)}}, tmp_path / "g_00000001")
    assert torch.equal(tckpt.load_checkpoint(str(tmp_path / "g_00000001"))["generator"]["w"],
                       torch.ones(2))
    # a torch file by name, whatever its bytes
    torch.save({"x": torch.zeros(1)}, tmp_path / "legacy.pt")
    assert "x" in tckpt.load_checkpoint(str(tmp_path / "legacy.pt"))
    np.testing.assert_array_equal(tckpt.load_torch_checkpoint(str(tmp_path / "g_00000001"))[
        "generator"]["w"], jckpt.load_torch_checkpoint(str(tmp_path / "g_00000001"))[
        "generator"]["w"])


def test_save_checkpoint_async_and_wait(tmp_path):
    obj = {"generator": {"w": torch.arange(4.0)}}
    tckpt.save_checkpoint(str(tmp_path / "sync"), obj)
    for i in range(3):
        tckpt.save_checkpoint(str(tmp_path / f"g_{i:08d}"), obj, async_=True)
    obj["generator"]["w"].add_(1)  # the write holds the values of the call
    tckpt.wait_for_checkpoints()
    assert not tckpt._PENDING
    for i in range(3):
        got = tckpt.load_checkpoint(str(tmp_path / f"g_{i:08d}"))["generator"]["w"]
        assert torch.equal(got, torch.arange(4.0))
    assert not any(p.suffix == ".tmp" for p in tmp_path.iterdir())
    assert os.path.basename(tckpt.scan_checkpoint(str(tmp_path), "g_")) == "g_00000002"


def _same_numpy(a, b):
    assert set(a) == set(b)
    for k in a:
        if isinstance(a[k], dict):
            _same_numpy(a[k], b[k])
        elif isinstance(a[k], np.ndarray) or isinstance(b[k], np.ndarray):
            np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]))
        else:
            assert a[k] == b[k]


@pytest.mark.parametrize("folded", [False, True])
def test_generator_interchange_matches_jax(tmp_path, folded):
    from hifigan_tpu.models import fold_weight_norm

    params = jax_params(small_config("1"))
    if folded:
        params = jax.tree_util.tree_map(np.asarray, fold_weight_norm(params))
    theirs = jckpt.export_torch_generator(params)
    ours = tckpt.export_torch_generator(params)
    _same_numpy(ours, theirs)
    _same_numpy(tckpt.convert_torch_generator(ours), jckpt.convert_torch_generator(theirs))
    tckpt.save_torch_generator(str(tmp_path / "g_port"), params)
    jckpt.save_torch_generator(str(tmp_path / "g_jax"), params)
    _same_numpy(tckpt.load_torch_checkpoint(str(tmp_path / "g_port")),
                jckpt.load_torch_checkpoint(str(tmp_path / "g_jax")))


def test_discriminator_interchange_matches_jax(tmp_path):
    from hifigan_tpu.models import MultiPeriodDiscriminator, MultiScaleDiscriminator

    x = jax.numpy.zeros((1, 256))
    mpd = jax.tree_util.tree_map(np.asarray, MultiPeriodDiscriminator().init(
        jax.random.PRNGKey(0), x, x))
    msd = jax.tree_util.tree_map(np.asarray, MultiScaleDiscriminator().init(
        jax.random.PRNGKey(1), x, x))
    theirs = jckpt.export_torch_discriminators(mpd, msd, steps=5, epoch=2)
    ours = tckpt.export_torch_discriminators(mpd, msd, steps=5, epoch=2)
    _same_numpy(ours, theirs)
    _same_numpy(tckpt.convert_torch_discriminators(ours),
                jckpt.convert_torch_discriminators(theirs))
    tckpt.save_torch_discriminators(str(tmp_path / "do_port"), mpd, msd, 5, 2)
    jckpt.save_torch_discriminators(str(tmp_path / "do_jax"), mpd, msd, 5, 2)
    _same_numpy(tckpt.load_torch_checkpoint(str(tmp_path / "do_port")),
                jckpt.load_torch_checkpoint(str(tmp_path / "do_jax")))


def _distill_config():
    import json

    with open(os.path.join(REPO, "configs", "distill.json")) as f:
        return json.load(f)


def test_yaml_reads_what_yaml_dump_writes():
    cfg = _distill_config()
    cfg["extra"] = {"eps": 1e-05, "inf": float("inf"), "none": None, "empty": {}, "seq": [],
                    "word": "yes", "num_text": "123", "colon": "a: b", "quote": "it's",
                    "nested": [[1, 2], [3]], "items": [{"a": 1, "b": [2]}], "flag": False,
                    "unicode": "\u00e9", "neg": -7}
    assert caching.load_yaml(yaml.dump(cfg)) == cfg


def test_yaml_dump_is_read_back_by_yaml():
    cfg = _distill_config()
    text = caching.dump_yaml(cfg)
    assert yaml.load(text, yaml.FullLoader) == cfg
    assert caching.load_yaml(text) == cfg
    assert text == yaml.dump(cfg)  # the shipped config has nothing to quote differently


@pytest.mark.parametrize("text,line", [("a: !!python/tuple\n- 1\n", 1), ("a: 1\nb: &x 2\n", 2),
                                       ("a:\n  b: [1, 2]\n", 2), ("a: |\n  x\n", 1),
                                       ("a: \"x\n  y\"\n", 1), ("a: 2001-12-14\n", 1),
                                       ("a: 1\n b: 2\n", 2), ("---\na: 1\n", 1)])
def test_yaml_refuses_what_it_does_not_read(text, line):
    with pytest.raises(ValueError, match=f"line {line}:"):
        caching.load_yaml(text)


def test_do_and_cache(tmp_path):
    calls = []
    path = tmp_path / "run" / "config.yaml"
    assert caching.do_and_cache(lambda: calls.append(1) or {"a": [1, 2]}, path) == {"a": [1, 2]}
    assert caching.do_and_cache(lambda: calls.append(1) or {"a": 3}, path) == {"a": [1, 2]}
    assert calls == [1] and yaml.safe_load(path.read_text()) == {"a": [1, 2]}
    out = caching.do_and_cache_dict(lambda: {"x": {"k": 1}, "y": [2]}, str(tmp_path / "{}.yaml"))
    again = caching.do_and_cache_dict(lambda: {"x": {"k": 9}, "y": [9]}, str(tmp_path / "{}.yaml"))
    assert out == again == {"x": {"k": 1}, "y": [2]}


def test_pytree_matches_jax():
    a = {"x": [1, 2, (3, 4)], "y": {"z": 5}}
    b = {"x": [10, 20, (30, 40)], "y": {"z": 50}}
    fn = lambda u, v, scale=1: (u + v) * scale  # noqa: E731
    assert pytree.get_recursive(fn, a, b, kwargs={"scale": 2}) == jpytree.get_recursive(
        fn, a, b, kwargs={"scale": 2})
    seen, jseen = [], []
    pytree.do_recursive(lambda u, v: seen.append(u * v), a, v=b)
    jpytree.do_recursive(lambda u, v: jseen.append(u * v), a, v=b)
    assert seen == jseen
    t = {"w": torch.ones(2, requires_grad=True) * 2, "n": [np.ones(1)]}
    d = pytree.detach_recursively(t, cpu=True)
    assert not d["w"].requires_grad and d["n"][0] is t["n"][0]


def test_restack_legacy_ensembles_matches_jax():
    rng = np.random.default_rng(3)
    template = {"params": {"m_0_ens": {"m_0_conv": {"v": np.zeros((3, 2, 1, 4)),
                                                    "bias": np.zeros((3, 4))},
                                       "m_1_conv": {"bias": np.zeros((3, 4))}},
                           "m_1_conv": {"bias": np.zeros(4)}}}
    legacy = {"params": {f"m_0_e{i}_{j}_conv": {"bias": rng.standard_normal(4)}
                         for i in range(3) for j in range(2)}}
    for i in range(3):
        legacy["params"][f"m_0_e{i}_0_conv"]["v"] = rng.standard_normal((2, 1, 4))
    legacy["params"]["m_1_conv"] = {"bias": rng.standard_normal(4)}
    want = jpytree.restack_legacy_ensembles(legacy, template)
    got = pytree.restack_legacy_ensembles(legacy, template)
    _same_numpy(got, jax.tree_util.tree_map(np.asarray, want))
    assert got["params"]["m_0_ens"]["m_0_conv"]["v"].shape == (3, 2, 1, 4)
    assert not any("_e1_" in k for k in got["params"])
