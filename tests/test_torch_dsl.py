"""The port's DSL interpreter (``hifigan_tpu_torch.dsl.module``) against the
JAX package's, node by node and for the distillation's generated models, on
the CPU with the same weights (carried from JAX)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from __graft_entry__ import _tiny_distill_config
from hifigan_tpu.distill.model import DistillModels as JaxDistillModels
from hifigan_tpu.dsl import static_configs as jstatic
from hifigan_tpu.dsl.parsing import parse_layers as jparse
from hifigan_tpu_torch.dsl import static_configs as tstatic
from hifigan_tpu_torch.dsl.module import ConfigurableModule, sorted_dicts
from hifigan_tpu_torch.dsl.parsing import parse_layers
from tests.torch_port_helpers import dsl_pair, leaves, run_cheap

ATOL = 2e-5
CONV = ("conv", (3, 3, 3))


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


NODES = {
    "conv": (("conv", (3, 5, 3, 1, 1, 1, 0.01)), (2, 16, 3)),
    "conv strided dilated spectral": (("conv", (3, 4, 3, 2, 2, 1, 0.01, "spectral")), (2, 17, 3)),
    "conv grouped norm none": (("conv", (4, 4, 3, 1, 1, 2, 0.5, "none")), (2, 16, 4)),
    "conv_rech": (("conv_rech", (3, 5, 3, None, 1, 1, 0.01)), (2, 20, 3)),
    "conv_shuffle g1": (("conv_shuffle", (4, 4, 3, 1, 1, 1, 0.01)), (2, 16, 4)),
    "conv_shuffle g2": (("conv_shuffle", (4, 4, 3, 1, 1, 2, 0.01)), (2, 16, 4)),
    "lrelu": ([CONV, ("lrelu", 0.2)], (2, 16, 3)),
    "tanh sigmoid": ([("tanh",), ("sigmoid",)], (2, 16, 3)),
    "avg_ch": (("avg_ch",), (2, 16, 3)),
    "softmax": (("softmax",), (2, 16, 3)),
    "res": (("res", [CONV, ("lrelu", 0.1)]), (2, 16, 3)),
    "sub_res pool": (("sub_res", ("pool", (5, 1))), (2, 16, 3)),
    "pool": (("pool", (4, 2)), (2, 16, 3)),
    "poold": (("poold", (5, 1, 2)), (2, 16, 3)),
    "roll": (("roll", (5,)), (2, 16, 2)),
    "roll reflect": (("roll", (3, "reflect")), (2, 16, 2)),
    "unroll": (("unroll", 2), (2, 16, 4)),
    "repl": (("repl", 3), (2, 16, 2)),
    "shuffle unshuffle": ([("shuffle", 2), CONV[:1] + ((4, 4, 1),), ("unshuffle", 2)], (2, 8, 4)),
    "up nearest": (("up", (2, "nearest")), (2, 8, 3)),
    "sum": (("sum", [[CONV], ("repl", 1)]), (2, 16, 3)),
    "fusion": (("fusion", [[CONV], ("tanh",)]), (2, 16, 3)),
    "split int": (("split", 1), (2, 8, 3)),
    "split dict recursive": ([("split", {"b": 1, "a": 2}),
                              ("recursive", {"b": ("tanh",), "a": ("softmax",)})], (2, 8, 3)),
    "split merge_dict": ([("split", {"b": 1, "a": 2}), ("merge_dict",)], (2, 8, 3)),
    "chunk list": ([("chunk", 3), ("list", [("tanh",), ("sigmoid",), ("conv", (1, 2, 3))])],
                   (2, 8, 3)),
    "dict": ([("split", {"a": 1, "b": 2}), ("dict", {"a": ("tanh",), "b": ("conv", (2, 2, 3))})],
             (2, 8, 3)),
    "valve": ([("valve", 0.5, ["skip"]), CONV], (2, 8, 3)),
    "mel": (("mel", (16000, 8, 16, 4)), (2, 62, 1)),
    "ensemble homogeneous": (("ensemble", [[CONV, ("lrelu", 0.1)]] * 3), (2, 16, 3)),
    "ensemble split in members": (("ensemble", [[CONV, ("split", {"b": 1, "a": 2})]] * 2),
                                  (2, 8, 3)),
    "ensemble heterogeneous": (("ensemble", [[CONV], [("conv", (3, 3, 5))]]), (2, 16, 3)),
    "fmap": (("fmap", ([("conv", (3, 3, 3), ["t"]), ("tanh",), ("lrelu", 0.1, ["t"])], ["t"])),
             (2, 16, 3)),
    "pfmap interpreted": (("pfmap", ([("conv", (3, 3, 3), ["t"]), ("tanh", ["t"])], ["t"],
                                     [[("conv", (3, 1, 3))]])), (2, 16, 3)),
    "encoder decoder": ([("encoder", ([("conv", (3, 4, 3))], [("conv", (4, 2, 3)), ("tanh",)])),
                         ("decoder", ([("conv", (2, 4, 3)), ("conv", (4, 4, 3))],
                                      [("conv", (4, 3, 3))]))], (2, 16, 3)),
}


@pytest.mark.parametrize("name", list(NODES))
def test_node_matches_jax(name):
    cfg, shape = NODES[name]
    x = _x(shape)
    jm, variables, tm = dsl_pair(cfg, x, torch_kw={"mel_sampling_rate_override": None})
    want = run_cheap(lambda v, xx: jm.apply(v, xx), variables, jnp.asarray(x))
    got = tm(torch.from_numpy(x))
    w, g = jax.tree_util.tree_leaves(want), leaves(got)
    assert len(w) == len(g) > 0
    for a, b in zip(w, g):
        np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), atol=ATOL, rtol=1e-5,
                                   err_msg=name)


def test_one_hot_and_noise_nodes():
    labels = np.array([[0, 2, 1, 3]], np.float32)
    tm = ConfigurableModule(("one_hot", (4, 1))).build(torch.from_numpy(labels))
    jm, variables, _ = dsl_pair(("one_hot", (4, 1)), labels)
    np.testing.assert_array_equal(tm(torch.from_numpy(labels)).numpy(),
                                  np.asarray(jm.apply(variables, jnp.asarray(labels))))
    noise = ConfigurableModule(("noise", 5)).build(torch.zeros(1, 8, 2))
    a = noise(torch.zeros(2, 8, 2), generator=torch.Generator().manual_seed(3))
    b = noise(torch.zeros(2, 8, 2), generator=torch.Generator().manual_seed(3))
    assert a.shape == (2, 8, 5) and torch.equal(a, b)


SHORT_NODES = {
    "conv2": (("conv2", (3, 4, 3, 1, 1, 1, 0.01)), (2, 8, 6, 3)),
    "trans": (("trans", (3, 4, 4, 2)), (2, 9, 3)),
    "trans_shuffle": (("trans_shuffle", (4, 2, 5, 3, 1, 2, 0.01)), (2, 7, 4)),
    "trans2": (("trans2", (3, 4, 3)), (2, 8, 6, 3)),
    "up linear": (("up", (3, "linear")), (2, 7, 3)),
}


@pytest.mark.parametrize("name", list(SHORT_NODES))
def test_short_nodes_match_jax(name):
    """The nodes no shipped config uses, against the JAX ones (trans2
    raises in both)."""
    cfg, shape = SHORT_NODES[name]
    x = _x(shape)
    if name == "trans2":
        with pytest.raises(NotImplementedError, match="trans2"):
            dsl_pair(cfg, x)
        with pytest.raises(NotImplementedError, match="trans2"):
            ConfigurableModule(cfg).build(torch.from_numpy(x[:1]))
        return
    jm, variables, tm = dsl_pair(cfg, x)
    want = run_cheap(lambda v, xx: jm.apply(v, xx), variables, jnp.asarray(x))
    got = tm(torch.from_numpy(x))
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL, rtol=1e-5,
                               err_msg=name)


def test_poold_strided_matches_jax():
    jm, variables, tm = dsl_pair(("poold", (3, 2, 4)), _x((2, 16, 3)))
    x = _x((2, 16, 3), 1)
    want = run_cheap(lambda v, xx: jm.apply(v, xx), variables, jnp.asarray(x))
    got = tm(torch.from_numpy(x))
    assert tuple(got.shape) == tuple(want.shape)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=1e-5)


FUSABLE = [("conv", (2, 4, 3, 1, 1, 1, 0.01)),
           ("res", [("lrelu", 0.1), ("conv", (4, 4, 3, 1, 1, 1, 0.01))]),
           ("sub_res", [("lrelu", 0.2), ("conv", (4, 4, 3, 1, 1, 1, 0.01))]),
           ("lrelu", 0.1)]


@pytest.mark.parametrize("impl", ["fused", "fused_interpret"])
def test_stream_impls_match_jax(impl):
    """Both fused values run the stream-fusion pass (on CPU tensors the
    stream graph's plain version) and match the JAX pass."""
    x = _x((2, 32, 2))
    jm, variables, tm = dsl_pair(FUSABLE, x, jax_kw={"stream_impl": "fused_interpret"},
                                 torch_kw={"stream_impl": impl})
    assert tm.stream_impl == impl
    want = run_cheap(lambda v, xx: jm.apply(v, xx), variables, jnp.asarray(x))
    np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=1e-5)
    with pytest.raises(ValueError):
        ConfigurableModule(("tanh",), stream_impl="xla")


def test_conv_impls_route_conv_nodes():
    """Every JAX ``conv_impl`` value is taken; 'pallas' sends conv and
    conv_rech nodes to the per-layer conv op except stride > 1 with
    dilation > 1, 'pallas_interpret' as an alias of 'pallas' (the op takes
    its plain version for CPU tensors), the others to the direct conv;
    ensemble members inherit the value."""
    for impl in ("auto", "xla", "folded", "pallas", "pallas_interpret"):
        assert ConfigurableModule(("tanh",), conv_impl=impl).conv_impl == impl
    with pytest.raises(ValueError):
        ConfigurableModule(("tanh",), conv_impl="cudnn")
    m = ConfigurableModule(("tanh",), conv_impl="pallas")
    assert [m._conv_backend(s, d) for s, d in ((1, 1), (2, 1), (1, 3), (2, 3))] == [
        "kernel", "kernel", "kernel", "direct"]
    assert ConfigurableModule(("tanh",), conv_impl="pallas_interpret")._conv_backend(2, 1) == "kernel"
    assert ConfigurableModule(("tanh",), conv_impl="folded")._conv_backend(1, 1) == "direct"
    ens = ConfigurableModule(("ensemble", [[CONV]] * 2), conv_impl="pallas")
    ens.build(torch.zeros(1, 8, 3))
    assert all(mem.conv_impl == "pallas" for mem in ens.ensembles["m_ens"])


def test_ensemble_members_see_sorted_dicts():
    cfg = ("ensemble", [[("split", {"b": 1, "a": 2})]] * 2)
    tm = ConfigurableModule(cfg).build(torch.zeros(1, 4, 3))
    member = tm.ensembles["m_ens"][0]
    assert member.config == sorted_dicts(tm.config[2][0])
    out = tm(torch.arange(3.0).reshape(1, 1, 3))["mean"]
    assert out["a"].tolist() == [[[0.0, 1.0]]] and out["b"].tolist() == [[[2.0]]]


def test_static_configs_are_the_jax_ones():
    cfg, labels, _ = _tiny_distill_config(3)
    for key in ("generator", "discriminator"):
        layers = cfg["models"][key]["layers"]
        assert parse_layers(layers) == jparse(layers)
    gl = parse_layers(cfg["models"]["generator"]["layers"])
    assert tstatic.get_generator_configs(gl, 2, 6) == jstatic.get_generator_configs(gl, 2, 6)
    dl = parse_layers(cfg["models"]["discriminator"]["layers"])
    assert tstatic.get_discriminator_config(dl, 1, 2) == jstatic.get_discriminator_config(dl, 1, 2)
    sl = parse_layers(cfg["models"]["sniffers"]["layers"])
    assert (tstatic.generate_sniffers_configs_by_example(labels, sl, 2)
            == jstatic.generate_sniffers_configs_by_example(labels, sl, 2))


@pytest.fixture(scope="module")
def tiny_models():
    cfg, labels, weights = _tiny_distill_config(3)
    return JaxDistillModels(cfg, labels, weights, sampling_rate=cfg["sampling_rate"],
                            member_impl="interpret")


@pytest.mark.parametrize("model", ["encoder", "decoder", "keepers", "hunters", "sniffers"])
def test_tiny_distill_models_match_jax(tiny_models, model):
    """The generated encoder/decoder and the classifier ensembles of the
    tiny production-schema config, weights carried from JAX."""
    m = tiny_models
    seg = 24
    half = m.embedding_channels // 2
    emb_t = seg // m.embedding_size
    if model == "encoder":
        mods = {"": (m.encoder.config, _x((2, seg, 1)))}
    elif model == "decoder":
        mods = {"": (m.decoder.config, None)}
    else:
        group = getattr(m, model)
        mods = {k: (mod.config, _x((2, emb_t, half), i)) for i, (k, mod) in enumerate(group.items())}
    for key, (cfg, x) in mods.items():
        if model == "decoder":  # its input: the encoder's {content, style} of a waveform
            xe = _x((2, seg, 1))
            je, ve, _ = dsl_pair(m.encoder.config, xe)
            x = jax.tree_util.tree_map(np.asarray, run_cheap(je.apply, ve, jnp.asarray(xe)))
        elif model == "sniffers":  # its input: a keeper's {label: probabilities}
            x = {g: np.abs(_x((2, emb_t, len(v)), 7)) for g, v in m.example_labels[key].items()}
        jm, variables, tm = dsl_pair(cfg, x)
        want = run_cheap(lambda v, xx: jm.apply(v, xx), variables,
                         jax.tree_util.tree_map(jnp.asarray, x))
        got = tm(jax.tree_util.tree_map(torch.from_numpy, x))
        w, g = jax.tree_util.tree_leaves(want), leaves(got)
        assert len(w) == len(g) > 0
        for a, b in zip(w, g):
            np.testing.assert_allclose(b.detach().numpy(), np.asarray(a), atol=ATOL, rtol=1e-5,
                                       err_msg=f"{model} {key}")
