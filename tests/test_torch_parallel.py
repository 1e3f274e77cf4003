"""The port's mesh, tensor x data parallel V1 step, halo exchange, sharded
generator and the conv stack's batch-sharded form, on 4 gloo ranks, against
the single-process port and the JAX package on its virtual CPU devices.

The ranks are spawned once for the file (``tests/torch_parallel_ranks.py``
does their work) and run while the JAX references compile.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from hifigan_tpu.parallel import halo as jhalo
from hifigan_tpu.parallel import mesh as jmesh
from hifigan_tpu.train import vocoder as jv
from hifigan_tpu.train.checkpoint import convert_torch_generator
from hifigan_tpu_torch.config import AttrDict
from hifigan_tpu_torch.models import Generator
from hifigan_tpu_torch.ops.conv_stack import LayerSpec, fused_conv_stack
from hifigan_tpu_torch.parallel import mesh as tmesh
from hifigan_tpu_torch.parallel.halo import generator_halo_frames
from hifigan_tpu_torch.train import vocoder as tv
from hifigan_tpu_torch.train.checkpoint import (
    discriminator_state_dict_from_jax,
    generator_state_dict_from_jax,
)
from tests.test_torch_train import _derived, _jax_state, _to_port
from tests.torch_parallel_ranks import join_ranks, start_ranks, state_dicts, v1_work
from tests.torch_port_helpers import CHEAP_CODEGEN, tiny_train_config

N = 4
LR_FLIP_FRACTION = 1e-3


def _stack_inputs(rng):
    specs = [LayerSpec(16, 5, 1, 2, 2, 2, 0.1), LayerSpec(16, 3, 2, 4, 1, 1, 0.1),
             LayerSpec(1, 3, 1, 1, 1, 1, 1.0)]
    ks, bs, c = [], [], 8
    for sp in specs:
        ks.append((rng.standard_normal((sp.kernel, c // sp.groups, sp.c_out)) * 0.2)
                  .astype(np.float32))
        bs.append((rng.standard_normal(sp.c_out) * 0.1).astype(np.float32))
        c = sp.c_out
    return specs, ks, bs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    h = tiny_train_config()
    rng = np.random.default_rng(0)
    gen = Generator(h, generator=torch.Generator().manual_seed(2))
    halo = generator_halo_frames(h)
    stack = _stack_inputs(rng)
    stack_x = rng.standard_normal((N, 24, 8)).astype(np.float32)
    with torch.no_grad():
        cot_shapes = [y.shape for y in fused_conv_stack(torch.from_numpy(stack_x),
                                                        [torch.from_numpy(k) for k in stack[1]],
                                                        [torch.from_numpy(b) for b in stack[2]],
                                                        stack[0])]
    inputs = {
        "h": h, "halo": 3, "halo_x": rng.standard_normal((2, N * 8, 5)).astype(np.float32),
        "gen_sd": {k: v.numpy() for k, v in gen.state_dict().items()},
        "mel": rng.standard_normal((2, h["num_mels"], N * (2 * halo + 6))).astype(np.float32),
        "audio": (rng.standard_normal((4, h["segment_size"])) * 0.1).astype(np.float32),
        "stack": stack, "stack_x": stack_x,
        "forms_h": dict(h, msd_width=128, msd_conv_impl="fused_zoned", disc_fused=True),
        "stack_cot": [rng.standard_normal(s).astype(np.float32) for s in cot_shapes],
    }
    tmp = tmp_path_factory.mktemp("ranks")
    ctx = start_ranks(v1_work, N, tmp, inputs)

    # the JAX references, meanwhile
    devices = jax.devices()[:N]
    mesh22 = jmesh.create_mesh(model=2, devices=devices)
    mesh4 = jmesh.create_mesh(devices=devices)
    state = tv.create_train_state(h, seed=0, device="cpu")
    jstate = _jax_state(h, state)
    jsh = jmesh.tensor_parallel_shardings(jstate, mesh22, min_size=8)
    jstep = jv.make_train_step(h, mesh=mesh22, donate=False, state_shardings=jsh)
    jstate = jax.device_put(jstate, jsh)
    batch = jmesh.shard_batch({"audio": inputs["audio"]}, mesh22)
    j1, jm = jstep.lower(jstate, batch).compile(compiler_options=CHEAP_CODEGEN)(jstate, batch)

    def windows(x):
        w, off = jhalo.halo_exchange(x, inputs["halo"], "data")
        return w, off[None]

    jwin, joff = jax.jit(jax.shard_map(windows, mesh=mesh4, in_specs=P(None, "data"),
                                       out_specs=(P(None, "data"), P("data"))))(
        jnp.asarray(inputs["halo_x"]))
    gen_params = convert_torch_generator(inputs["gen_sd"])["params"]
    jwav = jhalo.make_sharded_generator(h, mesh4, folded=False)(gen_params,
                                                                 jnp.asarray(inputs["mel"]))

    # the single-process port step on the logical batch
    single = tv.create_train_state(h, seed=0, device="cpu")
    _, sm = tv.make_train_step(h)(single, {"audio": inputs["audio"]})
    forms_h = AttrDict(inputs["forms_h"])
    forms = tv.create_train_state(forms_h, seed=0, device="cpu")
    _, fm = tv.make_train_step(forms_h)(forms, {"audio": inputs["audio"]})
    with torch.no_grad():
        full_wav = gen(torch.from_numpy(inputs["mel"])).numpy()

    ranks = join_ranks(ctx, N, tmp)
    return dict(h=h, inputs=inputs, ranks=ranks, jstate=jstate, jsh=jsh,
                jafter=_to_port(j1), jm={k: float(v) for k, v in jm.items()},
                jwin=np.asarray(jwin), joff=np.asarray(joff), jwav=np.asarray(jwav),
                single=state_dicts(single), sm={k: float(v) for k, v in sm.items()},
                forms=state_dicts(forms), fm={k: float(v) for k, v in fm.items()},
                full_wav=full_wav)


def test_mesh_shape(runs):
    assert all(r["shape"] == {"data": 2, "model": 2} for r in runs["ranks"])


def _markers(tree, shardings):
    """Each JAX leaf filled with its channel index along the last axis where
    the rule splits it, else with -1."""
    def fill(leaf, sh):
        a = np.asarray(leaf)
        if a.ndim and sh.spec and sh.spec[-1] == "model":
            return np.broadcast_to(np.arange(a.shape[-1], dtype=np.float32), a.shape).copy()
        return np.full(a.shape, -1.0, np.float32)

    return jax.tree_util.tree_map(fill, tree, shardings)


def test_tensor_parallel_rule_names_what_the_jax_rule_names(runs):
    """The port's rule splits the parameters the JAX rule splits, on the
    channels the JAX rule splits (read back through the weight carriers)."""
    js, sh = runs["jstate"], runs["jsh"]
    carried = {"generator": generator_state_dict_from_jax(_markers(js.params_g, sh.params_g)),
               **discriminator_state_dict_from_jax(
                   {"params": _markers(js.params_mpd, sh.params_mpd)},
                   {"params": _markers(js.params_msd, sh.params_msd),
                    "spectral": jax.tree_util.tree_map(np.asarray, js.spectral_msd)})}
    port = runs["ranks"][0]["shardings"]
    assert all(r["shardings"] == port for r in runs["ranks"])
    split = 0
    for name, axis in port.items():
        top, key = name.split(".", 1)
        m = carried[top][key].numpy()
        if axis is None:
            assert (m == -1).all(), name
            continue
        split += 1
        want = np.arange(m.shape[axis], dtype=np.float32).reshape(
            [-1 if d == axis else 1 for d in range(m.ndim)])
        np.testing.assert_array_equal(m, np.broadcast_to(want, m.shape), err_msg=name)
    assert split > 10
    held = runs["ranks"][0]["held"]
    assert len(held) == split
    for name, (shape, moment) in held.items():
        assert shape == moment and np.prod(shape) * 2 == np.prod(
            runs["single"][name.split(".")[0]][name.split(".", 1)[1]].shape), name


def test_halo_exchange_matches_jax(runs):
    t = runs["inputs"]["halo_x"].shape[1] // N + 2 * runs["inputs"]["halo"]
    for r, got in enumerate(runs["ranks"]):
        np.testing.assert_array_equal(got["window"], runs["jwin"][:, r * t:(r + 1) * t])
        assert got["offset"] == int(runs["joff"][r])
    assert [g["offset"] for g in runs["ranks"]] == [0, 3, 3, 6]


def test_sharded_generator_matches_full_and_jax(runs):
    for got in runs["ranks"]:
        np.testing.assert_allclose(got["wav"], runs["full_wav"], atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(got["wav"], runs["jwav"], atol=1e-5, rtol=1e-5)


def test_tp_dp_step_matches_the_single_process_step(runs):
    for got in runs["ranks"]:
        for k, v in runs["sm"].items():
            np.testing.assert_allclose(got["metrics"][k], v, rtol=2e-5, err_msg=k)
        for group, sd in runs["single"].items():
            for key, want in sd.items():
                np.testing.assert_allclose(got["after"][group][key], want, atol=1e-5, rtol=1e-4,
                                           err_msg=f"{group}.{key}")


def test_dp_step_with_the_zoned_msd_and_disc_fused_matches_the_single_process_step(runs):
    """``msd_conv_impl='fused_zoned'`` (width 128) with ``disc_fused``: each
    rank's 2 x its rows through the fused discriminators, the zone chain's
    stack in its mesh form on them."""
    for got in runs["ranks"]:
        for k, v in runs["fm"].items():
            np.testing.assert_allclose(got["forms_metrics"][k], v, rtol=2e-5, err_msg=k)
        for group, sd in runs["forms"].items():
            for key, want in sd.items():
                np.testing.assert_allclose(got["forms_after"][group][key], want, atol=1e-5,
                                           rtol=1e-4, err_msg=f"{group}.{key}")


def test_tp_dp_step_matches_jax_on_its_mesh(runs):
    """At ``tests/test_torch_train.py``'s tolerances: metrics 1e-5; each
    parameter within 1e-6 except up to 0.1% of entries within 2 x lr (AdamW's
    first step moves a weight by about lr * sign(g))."""
    got = runs["ranks"][0]
    for k, v in runs["jm"].items():
        np.testing.assert_allclose(got["metrics"][k], v, rtol=1e-5, err_msg=k)
    lr = runs["h"]["learning_rate"]
    for group, ref in runs["jafter"].items():
        for key, want in ref.items():
            if _derived(key, ref):
                continue
            diff = np.abs(got["after"][group][key] - want.numpy())
            assert diff.max() <= 2 * lr + 1e-6, key
            assert (diff > 1e-6).mean() <= LR_FLIP_FRACTION, key


def test_conv_stack_mesh_form_gives_the_unsharded_values_and_gradients(runs):
    inp = runs["inputs"]
    specs, ks, bs = inp["stack"]
    kt = [torch.from_numpy(k).requires_grad_() for k in ks]
    bt = [torch.from_numpy(b).requires_grad_() for b in bs]
    ys = fused_conv_stack(torch.from_numpy(inp["stack_x"]), kt, bt, specs)
    sum((y * torch.from_numpy(c)).sum() for y, c in zip(ys, inp["stack_cot"])).backward()
    for got in runs["ranks"]:
        for a, b in zip(got["stack_ys"], ys):
            np.testing.assert_allclose(a, b.detach().numpy(), atol=1e-6, rtol=1e-6)
        for a, p in zip(got["stack_grads"], kt + bt):
            np.testing.assert_allclose(a, p.grad.numpy(), atol=1e-5, rtol=1e-5)


def test_conv_stack_mesh_form_refuses_a_batch_the_axis_does_not_divide():
    class Axis:
        shape = {"data": 3}

        @staticmethod
        def coordinate(axis):
            return 0

    specs, ks, bs = _stack_inputs(np.random.default_rng(1))
    with pytest.raises(ValueError, match=r"fused_conv_stack: batch 4 not divisible by mesh "
                                         r"axis 'data' \(3\)"):
        fused_conv_stack(torch.zeros(4, 24, 8), [torch.from_numpy(k) for k in ks],
                         [torch.from_numpy(b) for b in bs], specs, mesh=Axis())
    with tmesh.data_parallel_rows():  # a rank's own rows: no split, no check
        ys = fused_conv_stack(torch.zeros(4, 24, 8), [torch.from_numpy(k) for k in ks],
                              [torch.from_numpy(b) for b in bs], specs, mesh=Axis())
    assert ys[-1].shape[0] == 4
