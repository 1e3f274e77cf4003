"""The port's stream-fusion pass (``hifigan_tpu_torch.dsl.stream_fusion``)
against the JAX pass, on the CPU (the stream graph's plain version; the JAX
side's fused segments through its pure-jnp reference executor).

The generator is the one ``tests/test_dsl.py``'s fused parity test builds:
three levels (2, 6 and 30 channels at 150, 50 and 10 samples), expansion 2,
embedding 15. Tolerances: 2e-4 abs on the waveform, 1e-5 relative on
embeddings and the loss, and gradients within 1e-5 of each leaf's peak
(both passes sum in another order than the interpreter).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hifigan_tpu.dsl import stream_fusion as jsf
from hifigan_tpu.dsl.module import ConfigurableModule as JaxModule
from hifigan_tpu.dsl.parsing import parse_layers as jparse
from hifigan_tpu.dsl.static_configs import get_decaying_block
from hifigan_tpu.dsl.static_configs import get_generator_configs as jgen_configs
from hifigan_tpu.ops.pallas import stream_graph as jsg
from hifigan_tpu_torch.dsl import fused_member
from hifigan_tpu_torch.dsl import stream_fusion as sf
from hifigan_tpu_torch.dsl.module import ConfigurableModule
from hifigan_tpu_torch.ops import stream_graph as tsg
from hifigan_tpu_torch.train.checkpoint import dsl_state_dict_from_jax, dsl_variables_to_jax
from tests.torch_port_helpers import dsl_pair, leaves, run_cheap

LAYERS = ["res.1,none:1,3,1,1,1,1e-00", "res.1|conv.1,sub_res:1,3,3,1,1,1e-00",
          "res.1|conv.1,sub_res:3,3,5,1,1,1e-00"]
WAV_ATOL = 2e-4
RTOL = 1e-5
T = 150


def _x(shape, seed=7):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _configs():
    return jgen_configs(jparse(LAYERS), expansion_size=2, embedding_size=15)


def _port(cfg, variables, example, impl="fused_interpret"):
    tm = ConfigurableModule(cfg, stream_impl=impl)
    tm.build(jax.tree_util.tree_map(lambda a: torch.from_numpy(np.array(a[:1])), example),
             generator=torch.Generator().manual_seed(0))
    tm.load_state_dict({k: torch.from_numpy(np.array(v, dtype=np.float32))
                        for k, v in dsl_state_dict_from_jax(variables).items()})
    return tm


def _kinds(run_ops):
    return [(tuple(kind for _s, kind, _p in op.srcs), op.act, op.res_from) for op in run_ops]


@pytest.fixture(scope="module")
def pair():
    """JAX encoder/decoder variables, the JAX fused pass's loss, gradients
    and runs, and the port's modules carrying the same weights."""
    g = _configs()
    x = _x((2, T, 1))
    je, ve, _ = dsl_pair(g["encoder"], x)
    emb = jax.tree_util.tree_map(np.asarray, run_cheap(je.apply, ve, jnp.asarray(x)))
    jd, vd, _ = dsl_pair(g["decoder"], emb, seed=1)
    enc_f = JaxModule(config=g["encoder"], stream_impl="fused_interpret")
    dec_f = JaxModule(config=g["decoder"], stream_impl="fused_interpret")

    def loss(v, dv, xx):
        y = dec_f.apply(dv, enc_f.apply(v, xx))
        return jnp.sum(y * y)

    runs = []
    real = jsf._run_fused

    def recording(module, run, xx, **kw):
        runs.append((tuple(xx.shape), run))
        return real(module, run, xx, **kw)

    mp = pytest.MonkeyPatch()
    mp.setattr(jsg, "REFERENCE_EXECUTOR", True)
    mp.setattr(jsf, "_run_fused", recording)
    try:
        def both(v, dv, xx):
            emb_f = enc_f.apply(v, xx)
            return emb_f, dec_f.apply(dv, emb_f), jax.value_and_grad(loss, argnums=(0, 1, 2))(
                v, dv, xx)

        emb_f, wav_f, (lf, grads) = run_cheap(both, ve, vd, jnp.asarray(x))
    finally:
        mp.undo()
    return {"cfg": g, "x": x, "ve": ve, "vd": vd, "emb": emb, "runs": runs,
            "jax": {"emb": jax.tree_util.tree_map(np.asarray, emb_f), "wav": np.asarray(wav_f),
                    "loss": float(lf), "grads": jax.tree_util.tree_map(np.asarray, grads)},
            "enc": _port(g["encoder"], ve, x), "dec": _port(g["decoder"], vd, emb)}


def test_forward_matches_the_jax_pass(pair):
    x = torch.from_numpy(pair["x"])
    with torch.no_grad():
        emb = pair["enc"](x)
        wav = pair["dec"](emb)
    for a, b in zip(jax.tree_util.tree_leaves(pair["jax"]["emb"]), leaves(emb)):
        np.testing.assert_allclose(b.numpy(), a, rtol=RTOL, atol=RTOL * np.abs(a).max())
    np.testing.assert_allclose(wav.numpy(), pair["jax"]["wav"], rtol=0, atol=WAV_ATOL)
    assert float(wav.abs().max()) > 0


def test_gradients_match_the_jax_pass(pair):
    """Loss, input gradient and every parameter gradient of sum(y^2)."""
    enc, dec = pair["enc"], pair["dec"]
    for p in (*enc.parameters(), *dec.parameters()):
        p.grad = None
    x = torch.from_numpy(pair["x"]).requires_grad_(True)
    y = dec(enc(x))
    loss = (y * y).sum()
    loss.backward()
    want = pair["jax"]
    np.testing.assert_allclose(loss.item(), want["loss"], rtol=RTOL)
    gx = want["grads"][2]
    np.testing.assert_allclose(x.grad.numpy(), gx, rtol=0, atol=RTOL * np.abs(gx).max())
    for mod, jg in ((enc, want["grads"][0]), (dec, want["grads"][1])):
        got = dsl_variables_to_jax({k: p.grad for k, p in mod.named_parameters()})["params"]
        assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(jg["params"])
        n = 0
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(jg["params"]),
                                jax.tree_util.tree_leaves(got)):
            np.testing.assert_allclose(b, a, rtol=0, atol=RTOL * max(np.abs(a).max(), 1e-6),
                                       err_msg=jax.tree_util.keystr(path))
            n += 1
        assert n > 10


def test_runs_are_the_jax_passes(pair):
    """The port forms the JAX pass's runs (entry width, op sources,
    activations, residuals, convs) at every entry, encoder then decoder."""
    x = torch.from_numpy(pair["x"])
    got = []
    with torch.no_grad():
        emb, _ = sf.eval_stream_fused(pair["enc"], pair["enc"].config, x, "m", got)
        sf.eval_stream_fused(pair["dec"], pair["dec"].config, emb, "m", got)
    want = pair["runs"][:6]  # the forward's; the gradient's trace forms them again
    assert len(want) == len(got) == 6 and len(pair["runs"]) == 12
    for (ws, wr), (gx, gr, atoms) in zip(want, got):
        assert ws == tuple(gx.shape) and atoms
        assert (wr.entry_c, wr.n_convs, _kinds(wr.ops)) == (gr.entry_c, gr.n_convs, _kinds(gr.ops))
    assert [r.n_convs for _x, r, _a in got] == [2] * 6


def test_fusion_never_changes_the_parameters(pair):
    g = pair["cfg"]
    x = torch.from_numpy(pair["x"][:1])
    for key, example in (("encoder", x), ("decoder", None)):
        if example is None:
            with torch.no_grad():
                example = ConfigurableModule(g["encoder"]).build(x)(x)
        mods = [ConfigurableModule(g[key], stream_impl=impl).build(
            example, generator=torch.Generator().manual_seed(0))
            for impl in ("auto", "fused")]
        a, b = (m.state_dict() for m in mods)
        assert list(a) == list(b) and all(torch.equal(a[k], b[k]) for k in a)
        jv = pair["ve" if key == "encoder" else "vd"]
        assert (jax.tree_util.tree_structure(dsl_variables_to_jax(a))
                == jax.tree_util.tree_structure(jv))


def test_fallback_on_unsupported_nodes_matches_jax():
    """Valves and noise (get_decaying_block) stay on the interpreter at
    their own paths (tests/test_dsl.py:588)."""
    inner = [("conv", (4, 4, 3, 1, 1, 1, 0.01)), ("lrelu", 0.1), ("conv", (4, 4, 3, 1, 1, 1, 0.01))]
    cfg = [("conv", (2, 4, 3, 1, 1, 1, 0.01)), ("lrelu", 0.1),
           get_decaying_block(0.5, "skip", "anti", 4, inner),
           ("conv", (4, 2, 3, 1, 1, 1, 0.01)), ("tanh",)]
    x = _x((2, 64, 2), 9)
    jm, variables, _ = dsl_pair(cfg, x)
    want = run_cheap(lambda v, xx: jm.apply(v, xx, rngs={"noise": jax.random.PRNGKey(2)}),
                     variables, jnp.asarray(x))
    tm = _port(cfg, variables, x, impl="fused")
    got = tm(torch.from_numpy(x), generator=torch.Generator().manual_seed(2))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=RTOL, atol=2e-5)


def test_res_body_leading_activation_does_not_merge():
    """An activation at the head of a res/sub_res body must not merge into
    the residual source's op: res(x) adds x, not lrelu(x) (tests/test_dsl.py:611)."""
    cfg = [("conv", (2, 4, 3, 1, 1, 1, 0.01)),
           ("res", [("lrelu", 0.1), ("conv", (4, 4, 3, 1, 1, 1, 0.01))]),
           ("sub_res", [("lrelu", 0.2), ("conv", (4, 4, 3, 1, 1, 1, 0.01))]),
           ("lrelu", 0.1)]
    x = _x((2, 64, 2), 11)
    jm, variables, _ = dsl_pair(cfg, x)
    want = run_cheap(lambda v, xx: jm.apply(v, xx), variables, jnp.asarray(x))
    tm = _port(cfg, variables, x, impl="fused")
    rec = []
    with torch.no_grad():
        got, _ = sf.eval_stream_fused(tm, tm.config, torch.from_numpy(x), "m", rec)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=RTOL, atol=2e-5)
    (_, run, _atoms), = rec
    # the res/sub_res bodies' lrelus are act-only ops reading the protected slots
    assert [k for k, _a, _r in _kinds(run.ops)] == [("conv",), (), ("conv",), ("id",), (),
                                                   ("conv",), ("neg",)]
    assert run.ops[-1].act == "lrelu"


def test_a_run_the_kernels_refuse_is_cut_before_anything_runs(monkeypatch):
    """A run whose segment the kernels would refuse (here: more ops than a
    launch describes) ends where it still fits; nothing is launched to find
    out."""
    cfg = [("conv", (2, 2, 3))] + [("lrelu", 0.1), ("conv", (2, 2, 3))] * 12
    x = torch.from_numpy(_x((1, 32, 2), 3))
    tm = ConfigurableModule(cfg, stream_impl="fused").build(x)
    calls = []
    real = fused_member.fused_stream_graph
    monkeypatch.setattr(fused_member, "fused_stream_graph",
                        lambda seg, *a, **kw: calls.append(seg) or real(seg, *a, **kw))
    rec = []
    with torch.no_grad():
        got, _ = sf.eval_stream_fused(tm, tm.config, x, "m", rec)
        want = ConfigurableModule(cfg).build(x)
        want.load_state_dict(tm.state_dict())
        want = want(x)
    assert len(rec) == len(calls) == 2
    assert all(len(seg.ops) <= tsg.MAX_OPS for seg in calls)
    assert sum(r.n_convs for _x, r, _a in rec) == 13
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=RTOL, atol=1e-6)


def test_distill_step_with_fused_streams_matches_jax():
    """One distillation train step with ``models.stream_impl`` fused on
    both sides (the tiny production-schema config of test_torch_distill.py):
    the loss tree and every updated variable of the encoder and decoder."""
    import copy

    from hifigan_tpu.distill.model import DistillModels as JaxDistillModels
    from hifigan_tpu.distill.train import DistillTrainer as JaxDistillTrainer
    from hifigan_tpu_torch.distill.model import DistillModels
    from hifigan_tpu_torch.distill.train import DistillTrainer
    from hifigan_tpu_torch.train.checkpoint import (
        distill_state_dicts,
        distill_variables_from_jax,
        distill_variables_to_jax,
        load_distill_variables,
    )
    from tests.test_torch_distill import LOSS_RTOL, PARAM_ATOL, _batch, _config, _flat
    from tests.torch_port_helpers import CHEAP_CODEGEN

    cfg, labels, weights = _config()
    jcfg = copy.deepcopy(cfg)
    jcfg["models"]["stream_impl"] = "fused_interpret"
    cfg["models"]["stream_impl"] = "fused"
    jm = JaxDistillModels(jcfg, labels, weights, sampling_rate=cfg["sampling_rate"],
                          member_impl="interpret")
    jt = JaxDistillTrainer(jm, jcfg)
    seg = cfg["loops"]["train"]["segment_length"]
    jstate = run_cheap(lambda key: jt.create_state(key, seg), jax.random.PRNGKey(3))
    variables = jax.tree_util.tree_map(np.asarray, jstate.variables)
    batch = _batch(cfg, labels, jm.embedding_size, 4)
    mp = pytest.MonkeyPatch()
    mp.setattr(jsg, "REFERENCE_EXECUTOR", True)
    try:
        compiled = jt.make_train_step(donate=False).lower(
            jstate, batch, jax.random.PRNGKey(5)).compile(compiler_options=CHEAP_CODEGEN)
    finally:
        mp.undo()
    j1, jl = compiled(jstate, batch, jax.random.PRNGKey(5))

    models = DistillModels(cfg, labels, weights, sampling_rate=cfg["sampling_rate"], device="cpu")
    models.build(seg)
    load_distill_variables(models, distill_variables_from_jax(variables))
    rec = []
    real = sf.run_fused
    mp.setattr(sf, "run_fused", lambda module, run, x: rec.append(run) or real(module, run, x))
    try:
        trainer = DistillTrainer(models, cfg)
        _, tl = trainer.make_train_step()(trainer.create_state(build=False), batch)
    finally:
        mp.undo()
    # two runs a model call (the one-conv middle level stays interpreted),
    # the encoder and the decoder called twice each
    assert len(rec) == 8 and all(r.n_convs == 2 for r in rec)
    want, got = _flat(jax.tree_util.tree_map(np.asarray, jl)), _flat(tl)
    assert set(want) == set(got)
    for k, v in want.items():
        assert abs(got[k] - v) <= LOSS_RTOL * abs(v) + 1e-7, (k, got[k], v)
    after = distill_variables_to_jax(distill_state_dicts(models))
    for model in ("encoder", "decoder"):
        for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(j1.variables[model]),
                                jax.tree_util.tree_leaves(after[model])):
            np.testing.assert_allclose(b, np.asarray(a), rtol=0, atol=PARAM_ATOL,
                                       err_msg=f"{model}{jax.tree_util.keystr(path)}")


@pytest.mark.parametrize("kind,payload,c,ops,read", [
    ("id", (), 12, 12, 12), ("neg", (), 12, 12, 12), ("pool", (31,), 84, 32 * 84, 31 * 84),
    ("repl", (4,), 1, 4, 4), ("avg", (), 4, 5, 4)])
def test_bound_counts_a_constant_table_by_what_it_needs(kind, payload, c, ops, read):
    """chip_smoke.py's bound counts each constant table as the sum it is
    (an add per nonzero entry, one multiply unless the weight is +-1), not
    as a dense c_in x c_out product a tap."""
    from chip_smoke import table_work

    table = sf._const_table(kind, payload, c, torch.float32, torch.device("cpu"))
    assert table_work(table) == (ops, read)


def test_bound_counts_dw_on_the_trained_tables_only():
    """A run's segment: forward and dx the same operations (dense conv
    tables a multiply-add an entry, the constant ones their sums), dW a
    multiply-add an entry of the conv tables only, plus db."""
    from chip_smoke import segment_cost

    cfg = [("conv", (2, 4, 3, 1, 1, 1, 0.01)),
           ("sub_res", [("lrelu", 0.2), ("conv", (4, 4, 5, 1, 1, 1, 0.01)), ("pool", (3, 1))])]
    x = torch.from_numpy(_x((2, 40, 2), 5))
    tm = ConfigurableModule(cfg, stream_impl="fused").build(x)
    rec = []
    real = fused_member.fused_stream_graph
    mp = pytest.MonkeyPatch()
    mp.setattr(fused_member, "fused_stream_graph",
               lambda seg, ins, tabs, bs, **kw: rec.append((seg, tabs, bs))
               or real(seg, ins, tabs, bs, **kw))
    try:
        tm(x)
    finally:
        mp.undo()
    (seg, tabs, bs), = rec
    trained = [t.requires_grad for t in tabs]
    assert trained == [True, True, False, False]  # conv, conv, pool, neg
    cost = segment_cost(seg, tabs, bs, 2, 1, 4, trained)
    rows = 2 * 40
    conv = 2 * rows * (3 * 2 * 4 + 5 * 4 * 4)
    consts = rows * (4 * 4 + 4)  # the 3-tap pool's sums and scales, the neg's adds
    assert cost["ops"]["fwd"] == cost["ops"]["bwd_dx"] == conv + consts
    assert cost["ops"]["bwd_dw"] == conv + rows * 4 * 2  # db of the two biased ops
