"""The port's V1 GAN train step against the JAX step, on the CPU.

The port's ``create_train_state`` draws the weights; they reach the JAX
step through the JAX package's own reference-checkpoint converters
(``convert_torch_generator`` / ``convert_torch_discriminators``), and come
back through the port's ``*_state_dict_from_jax``. Both sides start Adam
from zero. The JAX step is compiled once for the file.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hifigan_tpu.data.meldataset import MelDataset as JaxMelDataset
from hifigan_tpu.train import vocoder as jv
from hifigan_tpu.train.checkpoint import convert_torch_discriminators, convert_torch_generator
from hifigan_tpu_torch.audio import save_wav
from hifigan_tpu_torch.cli import train as cli_train
from hifigan_tpu_torch.data.meldataset import MelDataset
from hifigan_tpu_torch.train import vocoder as tv
from hifigan_tpu_torch.train.checkpoint import (
    discriminator_state_dict_from_jax,
    generator_state_dict_from_jax,
    load_checkpoint,
)
from tests.torch_port_helpers import numpy_state, tiny_train_config

LR_FLIP_FRACTION = 1e-3
METRICS = ("loss_gen_all", "loss_disc_all", "loss_disc_f", "loss_disc_s", "mel_error")


def _batch(h, seed):
    rng = np.random.default_rng(seed)
    return {"audio": (rng.standard_normal((2, h["segment_size"])) * 0.1).astype(np.float32)}


def _jax_state(h, state):
    params_g = convert_torch_generator(numpy_state(state.generator))["params"]
    disc = convert_torch_discriminators({"mpd": numpy_state(state.mpd),
                                         "msd": numpy_state(state.msd)})
    tx_g, tx_d = jv.make_optimizers(h)
    params_mpd, params_msd = disc["mpd"]["params"], disc["msd"]["params"]
    return jv.VocoderTrainState(
        step=jnp.zeros((), jnp.int32), params_g=params_g, params_mpd=params_mpd,
        params_msd=params_msd, spectral_msd=disc["msd"]["spectral"], opt_g=tx_g.init(params_g),
        opt_d=tx_d.init({"mpd": params_mpd, "msd": params_msd}))


def _derived(key: str, state_dict: dict) -> bool:
    """A spectral conv's ``weight_v``: the power-iteration vector, not state."""
    return key.endswith(".weight_v") and key[:-len("_v")] + "_orig" in state_dict


def _to_port(jstate) -> dict:
    tree = jax.tree_util.tree_map(np.asarray, jstate)
    disc = discriminator_state_dict_from_jax(
        {"params": tree.params_mpd}, {"params": tree.params_msd, "spectral": tree.spectral_msd})
    return {"generator": generator_state_dict_from_jax(tree.params_g), **disc}


@pytest.fixture(scope="module")
def runs():
    """Two steps of each package from the same weights and batches."""
    h = tiny_train_config()
    state = tv.create_train_state(h, seed=0, device="cpu")
    jstate = _jax_state(h, state)
    batches = [_batch(h, 0), _batch(h, 1)]
    step = jv.make_train_step(h, donate=False)
    # the reference is compiled with the backend's cheap codegen: the HLO is
    # the same, the one-core compile about half as long
    compiled = step.lower(jstate, batches[0]).compile(
        compiler_options={"xla_backend_optimization_level": 0,
                          "xla_llvm_disable_expensive_passes": True})
    j1, jm1 = compiled(jstate, batches[0])
    j2, jm2 = compiled(j1, batches[1])
    jax.block_until_ready((j2, jm2))
    port_step = tv.make_train_step(h)
    u0 = {k: v.clone() for k, v in state.spectral_msd.items()}
    state, m1 = port_step(state, batches[0])
    after1 = {name: {k: v.clone() for k, v in getattr(state, name).state_dict().items()}
              for name in ("generator", "mpd", "msd")}
    state, m2 = port_step(state, batches[1])
    return dict(h=h, jm=[jm1, jm2], m=[m1, m2], j1=_to_port(j1), after1=after1, u0=u0,
                state=state)


@pytest.mark.parametrize("step,rtol", [(0, 1e-5), (1, 1e-4)])
def test_metrics_match_jax(runs, step, rtol):
    jm, m = runs["jm"][step], runs["m"][step]
    assert set(m) == set(jm) == set(METRICS)
    for k in METRICS:
        np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=rtol, err_msg=k)


@pytest.mark.parametrize("group", ["generator", "mpd", "msd"])
def test_parameters_after_one_step_match_jax(runs, group):
    """Within 1e-6, except that AdamW's first step moves a weight by about
    lr * sign(g): where a gradient is float noise around zero its sign may
    differ between the packages, so up to 0.1% of a tensor's entries may
    differ by up to 2 * lr."""
    lr = runs["h"]["learning_rate"]
    ref, got = runs["j1"][group], runs["after1"][group]
    for key, want in ref.items():
        if _derived(key, ref):
            continue
        diff = (got[key] - want).abs()
        assert diff.max().item() <= 2 * lr + 1e-6, key
        assert (diff > 1e-6).float().mean().item() <= LR_FLIP_FRACTION, key


def test_spectral_u_moves_and_matches_jax(runs):
    u_port = runs["after1"]["msd"]
    moved = 0
    for key, u0 in runs["u0"].items():
        np.testing.assert_allclose(u_port[key].numpy(), runs["j1"]["msd"][key].numpy(), atol=1e-6)
        moved += u0.numel() > 1 and not torch.allclose(u0, u_port[key])
    assert moved


def test_step_counts_and_metrics_are_finite(runs):
    assert runs["state"].step == 2
    assert all(np.isfinite(v.item()) for m in runs["m"] for v in m.values())


def test_weight_carriers_round_trip(runs):
    """port state_dict -> JAX converters -> port carriers is the identity."""
    state = runs["state"]
    back = _to_port(_jax_state(runs["h"], state))
    for name in ("generator", "mpd", "msd"):
        mine = getattr(state, name).state_dict()
        assert set(back[name]) == set(mine)
        for k, v in back[name].items():
            if not _derived(k, mine):
                torch.testing.assert_close(v, mine[k], rtol=0, atol=0)


@pytest.fixture(scope="module")
def fused_runs():
    """Step 1 of each package with ``disc_fused: true`` (real and fake as
    one 2B batch through every sub-discriminator) from the same weights."""
    h = tiny_train_config()
    h["disc_fused"] = True
    state = tv.create_train_state(h, seed=0, device="cpu")
    jstate = _jax_state(h, state)
    batch = _batch(h, 2)
    step = jv.make_train_step(h, donate=False)
    compiled = step.lower(jstate, batch).compile(
        compiler_options={"xla_backend_optimization_level": 0,
                          "xla_llvm_disable_expensive_passes": True})
    j1, jm1 = compiled(jstate, batch)
    jax.block_until_ready((j1, jm1))
    assert state.mpd.fused and state.msd.fused
    u0 = {k: v.clone() for k, v in state.spectral_msd.items()}
    state, m1 = tv.make_train_step(h)(state, batch)
    after = {name: {k: v.clone() for k, v in getattr(state, name).state_dict().items()}
             for name in ("generator", "mpd", "msd")}
    return dict(h=h, jm=jm1, m=m1, j1=_to_port(j1), after=after, u0=u0)


def test_disc_fused_step_metrics_match_jax(fused_runs):
    jm, m = fused_runs["jm"], fused_runs["m"]
    assert set(m) == set(jm) == set(METRICS)
    for k in METRICS:
        np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=1e-5, err_msg=k)


@pytest.mark.parametrize("group", ["generator", "mpd", "msd"])
def test_disc_fused_parameters_after_one_step_match_jax(fused_runs, group):
    """As :func:`test_parameters_after_one_step_match_jax`; scale 0's ``u``
    took one power iteration a traversal of the fused 2B batch."""
    lr = fused_runs["h"]["learning_rate"]
    ref, got = fused_runs["j1"][group], fused_runs["after"][group]
    for key, want in ref.items():
        if _derived(key, ref):
            continue
        diff = (got[key] - want).abs()
        assert diff.max().item() <= 2 * lr + 1e-6, key
        assert (diff > 1e-6).float().mean().item() <= LR_FLIP_FRACTION, key


@pytest.fixture(scope="module")
def wav_dir(tmp_path_factory):
    root = tmp_path_factory.mktemp("wavs")
    rng = np.random.default_rng(7)
    names = []
    for i, n in enumerate((700, 900, 300, 1200, 650)):
        t = np.arange(n) / 8000
        wav = 0.4 * np.sin(2 * np.pi * (200 + 50 * i) * t) + 0.05 * rng.standard_normal(n)
        save_wav(str(root / f"utt{i}.wav"), wav.astype(np.float32), 8000)
        names.append(f"utt{i}")
    (root / "train.txt").write_text("\n".join(f"{n}|text" for n in names[:4]) + "\n")
    (root / "valid.txt").write_text(f"{names[4]}|text\n")
    return root


@pytest.mark.parametrize("mode", ["segments", "host_mel", "fine_tuning"])
def test_mel_dataset_matches_jax(wav_dir, tmp_path, mode):
    """The same seed gives the JAX dataset's crops, batches and host mels;
    ``fine_tuning`` reads teacher-forced ``.npy`` mels and aligned audio."""
    files = [str(wav_dir / f"utt{i}.wav") for i in range(5)]
    kw = dict(segment_size=256, n_fft=64, num_mels=8, hop_size=16, win_size=64,
              sampling_rate=8000, fmin=0, fmax=4000, seed=3, host_mel=mode == "host_mel")
    if mode == "fine_tuning":
        rng = np.random.default_rng(8)
        for i, n in enumerate((700, 900, 300, 1200, 650)):
            np.save(tmp_path / f"utt{i}.npy", rng.standard_normal((1, 8, n // 16 + 1)))
        kw.update(fine_tuning=True, base_mels_path=str(tmp_path))
    got = list(MelDataset(files, **kw).batches(2))
    want = list(JaxMelDataset(files, **kw).batches(2))
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert a.keys() == b.keys() and a["filenames"] == b["filenames"]
        for key in set(a) - {"filenames"}:
            np.testing.assert_allclose(a[key], b[key], rtol=0, atol=1e-5, err_msg=key)


def test_cli_train_writes_and_resumes_checkpoints(wav_dir, tmp_path):
    h = dict(tiny_train_config(), batch_size=2)
    config = tmp_path / "config.json"
    config.write_text(json.dumps(h))
    ckpt = tmp_path / "ckpt"

    def argv(epochs):
        return ["--config", str(config), "--checkpoint_path", str(ckpt), "--input_wavs_dir",
                str(wav_dir), "--input_training_file", str(wav_dir / "train.txt"),
                "--input_validation_file", str(wav_dir / "valid.txt"), "--training_epochs",
                str(epochs), "--checkpoint_interval", "2", "--validation_interval", "2",
                "--device", "cpu"]

    state = cli_train.main(argv(1))  # 4 files, batch 2: 2 steps an epoch
    assert state.step == 2
    assert (ckpt / "config.json").exists()
    do = load_checkpoint(str(ckpt / "do_00000002"))
    assert do["steps"] == 2 and do["epoch"] == 0 and set(do) == {
        "mpd", "msd", "optim_g", "optim_d", "steps", "epoch"}
    assert load_checkpoint(str(ckpt / "g_00000002"))["generator"].keys() == \
        state.generator.state_dict().keys()
    # the resume re-runs the saved epoch (0), then epoch 1, as the JAX loop does
    resumed = cli_train.main(argv(2))
    assert resumed.step == 6
    assert (ckpt / "do_00000004").exists() and (ckpt / "do_00000006").exists()
    assert resumed.opt_d.state_dict()["state"][0]["step"].item() == 6
