"""Vocoder GAN trainer (PyTorch port of ``hifigan_tpu/train/vocoder.py``).

Recipe: LSGAN discriminator loss on MPD + MSD; generator adversarial +
feature matching (x2) + 45 x mel-L1; two AdamW optimizers (betas from the
config, weight decay 0.01, eps 1e-8) with a per-epoch exponential decay.

One train step, in the JAX step's order:

1. the mels are computed inside the step (``fmax_for_loss`` for the loss
   mel), unless the batch brings a ``'mel'`` (fine-tuning input);
2. the generator runs forward once;
3. the D update, on the detached waveform, with the spectral power
   iteration advancing on MSD scale 0;
4. the G update against the refreshed discriminators, their parameters
   frozen and the MSD called with ``weight_grads=False``.

The step updates the state's modules and optimizers in place. Mixed
precision follows the JAX ``_cast``: ``gen_compute_dtype`` /
``disc_compute_dtype`` set the dtype every conv casts its input, kernel and
bias to; parameters and losses stay float32; no ``torch.autocast``.

Entry points run on CUDA unless ``device='cpu'`` is passed.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Any

import torch

from hifigan_tpu_torch.audio.mel import MelConfig, log_mel_spectrogram
from hifigan_tpu_torch.device import resolve_device
from hifigan_tpu_torch.models import Generator, MultiPeriodDiscriminator, MultiScaleDiscriminator
from hifigan_tpu_torch.models.losses import (
    discriminator_loss,
    feature_loss,
    generator_loss,
    mel_l1_loss,
)

def compute_dtype(value: Any) -> torch.dtype | None:
    """A config's ``*_compute_dtype`` ('bfloat16', 'float32' or None) as a torch dtype."""
    if value is None or isinstance(value, torch.dtype):
        return value
    return getattr(torch, str(value))


@dataclasses.dataclass
class VocoderTrainState:
    generator: Generator
    mpd: MultiPeriodDiscriminator
    msd: MultiScaleDiscriminator
    opt_g: torch.optim.AdamW
    opt_d: torch.optim.AdamW
    step: int
    device: torch.device

    @property
    def spectral_msd(self) -> dict[str, torch.Tensor]:
        """The MSD's spectral-norm ``u`` buffers (scale 0), by state_dict name."""
        return {k: v for k, v in self.msd.named_buffers() if k.endswith("weight_u")}


def build_discriminators(h, generator: torch.Generator | None = None):
    """MPD/MSD with reference widths unless ``h`` overrides them
    (``mpd_periods``, ``mpd_channels``, ``msd_width``, ``msd_num_scales``,
    ``msd_conv_impl``, ``disc_compute_dtype``, ``disc_fused``)."""
    dtype = compute_dtype(h.get("disc_compute_dtype"))
    fused = h.get("disc_fused", False)
    mpd = MultiPeriodDiscriminator(periods=tuple(h.get("mpd_periods", (2, 3, 5, 7, 11))),
                                   channels=tuple(h.get("mpd_channels", (32, 128, 512, 1024))),
                                   dtype=dtype, fused=fused, generator=generator)
    msd = MultiScaleDiscriminator(width=h.get("msd_width", 128),
                                  num_scales=h.get("msd_num_scales", 3), dtype=dtype,
                                  fused=fused, conv_impl=h.get("msd_conv_impl", "auto"),
                                  generator=generator)
    return mpd, msd


def make_optimizers(h, generator: torch.nn.Module, mpd: torch.nn.Module,
                    msd: torch.nn.Module) -> tuple[torch.optim.AdamW, torch.optim.AdamW]:
    def adamw(params):
        return torch.optim.AdamW(params, lr=h["learning_rate"], betas=(h["adam_b1"], h["adam_b2"]),
                                 eps=1e-8, weight_decay=0.01)

    return adamw(generator.parameters()), adamw([*mpd.parameters(), *msd.parameters()])


def set_learning_rate(opt: torch.optim.Optimizer, lr: float) -> None:
    """The per-epoch ExponentialLR step, set from the host."""
    for group in opt.param_groups:
        group["lr"] = lr


def create_train_state(h, seed: int | None = None,
                       device: str | torch.device | None = None) -> VocoderTrainState:
    """Seeded generator, MPD, MSD and their AdamW pair on ``device`` (CUDA by default)."""
    dev = resolve_device(device)
    gen_rng = torch.Generator().manual_seed(h["seed"] if seed is None else seed)
    generator = Generator(h, generator=gen_rng, dtype=compute_dtype(h.get("gen_compute_dtype")))
    mpd, msd = build_discriminators(h, generator=gen_rng)
    generator, mpd, msd = generator.to(dev), mpd.to(dev), msd.to(dev)
    opt_g, opt_d = make_optimizers(h, generator, mpd, msd)
    return VocoderTrainState(generator, mpd, msd, opt_g, opt_d, 0, dev)


def _as_tensor(value, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(value, dtype=torch.float32, device=device)


def make_train_step(h):
    """(state, batch) -> (state, metrics); batch: {'audio': (B, T) float32,
    optional 'mel': (B, num_mels, F)}. Metrics stay on the device."""
    mel_cfg = MelConfig.from_hparams(h)
    mel_loss_cfg = MelConfig.from_hparams(h, fmax_key="fmax_for_loss")

    def step_fn(state: VocoderTrainState, batch: dict):
        y = _as_tensor(batch["audio"], state.device)
        mel_in = batch.get("mel")
        mel_in = (log_mel_spectrogram(y, mel_cfg) if mel_in is None
                  else _as_tensor(mel_in, state.device))
        y_mel = log_mel_spectrogram(y, mel_loss_cfg)

        y_g_hat = state.generator(mel_in)[:, 0, :]
        y_hat_sg = y_g_hat.detach()

        # discriminator update
        state.opt_d.zero_grad(set_to_none=True)
        f_r, f_g, _, _ = state.mpd(y, y_hat_sg, update_spectral=True)
        s_r, s_g, _, _ = state.msd(y, y_hat_sg, update_spectral=True)
        loss_disc_f, _, _ = discriminator_loss(f_r, f_g)
        loss_disc_s, _, _ = discriminator_loss(s_r, s_g)
        loss_disc_all = loss_disc_f + loss_disc_s
        loss_disc_all.backward()
        state.opt_d.step()

        # generator update against the refreshed, frozen discriminators
        d_params = [*state.mpd.parameters(), *state.msd.parameters()]
        for p in d_params:
            p.requires_grad_(False)
        loss_mel = mel_l1_loss(y_mel, log_mel_spectrogram(y_g_hat, mel_loss_cfg)) * 45.0
        _, y_df_g, fmap_f_r, fmap_f_g = state.mpd(y, y_g_hat, update_spectral=True)
        _, y_ds_g, fmap_s_r, fmap_s_g = state.msd(y, y_g_hat, update_spectral=True,
                                                  weight_grads=False)
        loss_gen_f, _ = generator_loss(y_df_g)
        loss_gen_s, _ = generator_loss(y_ds_g)
        loss_gen_all = (loss_gen_f + loss_gen_s + feature_loss(fmap_f_r, fmap_f_g)
                        + feature_loss(fmap_s_r, fmap_s_g) + loss_mel)
        state.opt_g.zero_grad(set_to_none=True)
        loss_gen_all.backward()
        for p in d_params:
            p.requires_grad_(True)
        state.opt_g.step()

        state.step += 1
        metrics = {"loss_gen_all": loss_gen_all, "loss_disc_all": loss_disc_all,
                   "loss_disc_f": loss_disc_f, "loss_disc_s": loss_disc_s,
                   "mel_error": loss_mel / 45.0}
        return state, {k: v.detach() for k, v in metrics.items()}

    return step_fn


def make_eval_step(h):
    """Validation: (generator, batch) -> (full-band mel L1, y_hat (B, T))."""
    mel_cfg = MelConfig.from_hparams(h)
    mel_loss_cfg = MelConfig.from_hparams(h, fmax_key="fmax_for_loss")

    @torch.no_grad()
    def eval_fn(generator: Generator, batch: dict):
        device = next(generator.parameters()).device
        y = _as_tensor(batch["audio"], device)
        mel_in = batch.get("mel")
        mel_in = (log_mel_spectrogram(y, mel_cfg) if mel_in is None
                  else _as_tensor(mel_in, device))
        y_hat = generator(mel_in)[:, 0, :]
        err = mel_l1_loss(log_mel_spectrogram(y, mel_loss_cfg),
                          log_mel_spectrogram(y_hat, mel_loss_cfg))
        return err, y_hat

    return eval_fn


# ---------------------------------------------------------------------------
# Host training loop
# ---------------------------------------------------------------------------


def save_train_checkpoints(checkpoint_path: str, state: VocoderTrainState, epoch: int) -> None:
    """``g_<steps>`` and ``do_<steps>`` beside each other."""
    from hifigan_tpu_torch.train.checkpoint import save_checkpoint

    save_checkpoint(os.path.join(checkpoint_path, f"g_{state.step:08d}"),
                    {"generator": state.generator.state_dict()})
    save_checkpoint(os.path.join(checkpoint_path, f"do_{state.step:08d}"),
                    {"mpd": state.mpd.state_dict(), "msd": state.msd.state_dict(),
                     "optim_g": state.opt_g.state_dict(), "optim_d": state.opt_d.state_dict(),
                     "steps": state.step, "epoch": epoch})


def restore_train_checkpoints(checkpoint_path: str, state: VocoderTrainState) -> int:
    """Load the latest ``g_*`` / ``do_*``; return the epoch to resume (-1: none)."""
    from hifigan_tpu_torch.train.checkpoint import load_checkpoint, scan_checkpoint

    last_epoch = -1
    cp_g = scan_checkpoint(checkpoint_path, "g_")
    cp_do = scan_checkpoint(checkpoint_path, "do_")
    if cp_g is not None:
        state.generator.load_state_dict(load_checkpoint(cp_g, state.device)["generator"])
    if cp_do is not None:
        do = load_checkpoint(cp_do, state.device)
        state.mpd.load_state_dict(do["mpd"])
        state.msd.load_state_dict(do["msd"])
        if "optim_g" in do and "optim_d" in do:
            state.opt_g.load_state_dict(do["optim_g"])
            state.opt_d.load_state_dict(do["optim_d"])
        state.step = int(do["steps"])
        last_epoch = int(do.get("epoch", -1))
        print(f"Restored checkpoint at step {state.step}, epoch {last_epoch}")
    return last_epoch


def train(a, h, device: str | torch.device | None = None, writer=None) -> VocoderTrainState:
    """The training loop: checkpoints every ``checkpoint_interval`` steps,
    stdout/summary scalars, validation mel error and audio. ``a`` carries
    the CLI surface (checkpoint_path, training_epochs, *_interval,
    fine_tuning, input_* paths). The JAX loop's validation spectrogram
    figures need a plotting module the port does not have yet."""
    from hifigan_tpu_torch.data.meldataset import MelDataset, get_dataset_filelist

    state = create_train_state(h, device=device)
    os.makedirs(a.checkpoint_path, exist_ok=True)
    last_epoch = restore_train_checkpoints(a.checkpoint_path, state)

    training_files, validation_files = get_dataset_filelist(
        a.input_training_file, a.input_validation_file, a.input_wavs_dir)
    ds_kwargs = dict(segment_size=h["segment_size"], n_fft=h["n_fft"], num_mels=h["num_mels"],
                     hop_size=h["hop_size"], win_size=h["win_size"],
                     sampling_rate=h["sampling_rate"], fmin=h["fmin"], fmax=h["fmax"],
                     fmax_loss=h.get("fmax_for_loss"),
                     fine_tuning=getattr(a, "fine_tuning", False),
                     base_mels_path=getattr(a, "input_mels_dir", None))
    trainset = MelDataset(training_files, **ds_kwargs)
    validset = MelDataset(validation_files, **ds_kwargs, shuffle=False)

    train_step = make_train_step(h)
    eval_step = make_eval_step(h)
    for epoch in range(max(0, last_epoch), a.training_epochs):
        lr = h["learning_rate"] * (h["lr_decay"] ** epoch)
        set_learning_rate(state.opt_g, lr)
        set_learning_rate(state.opt_d, lr)
        t_epoch = time.time()
        for batch in trainset.batches(h["batch_size"]):
            batch.pop("filenames", None)
            t0 = time.time()
            state, metrics = train_step(state, batch)
            steps = state.step
            if steps % a.stdout_interval == 0:
                print(f"Steps: {steps}, Gen Loss Total: {metrics['loss_gen_all'].item():.3f}, "
                      f"Mel-Spec. Error: {metrics['mel_error'].item():.3f}, "
                      f"s/b: {time.time() - t0:.3f}")
            if writer is not None and steps % a.summary_interval == 0:
                for k, v in metrics.items():
                    writer.add_scalar(f"training/{k}", v.item(), steps)
                writer.add_scalar("training/learning_rate", lr, steps)
            if steps % a.checkpoint_interval == 0:
                save_train_checkpoints(a.checkpoint_path, state, epoch)
            if steps % a.validation_interval == 0:
                val_err, n = 0.0, 0
                for vb in validset.batches(1, shuffle=False, drop_last=False):
                    vb.pop("filenames", None)
                    err, y_hat = eval_step(state.generator, vb)
                    val_err += err.item()
                    if writer is not None and n < 4:
                        writer.add_audio(f"generated/y_hat_{n}", y_hat[0].cpu().numpy()[:, None],
                                         steps, h["sampling_rate"])
                    n += 1
                if n:
                    val_err /= n
                    print(f"Steps: {steps}, Validation Mel-Spec. Error: {val_err:.4f}")
                    if writer is not None:
                        writer.add_scalar("validation/mel_spec_error", val_err, steps)
        print(f"Epoch {epoch + 1} took {time.time() - t_epoch:.1f}s")
    return state
