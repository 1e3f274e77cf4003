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

Discriminator forms (``build_discriminators``), as the JAX trainer reads
them:

- ``msd_conv_impl`` (``'auto'``, ``'xla'``, ``'fused_stack'``,
  ``'fused_zoned'``, ``'pallas'``): how the MSD's convs run
  (``models/discriminators.py``). Every form computes the same logits.
  ``'fused_zoned'`` returns the zone chain's feature maps (layers 2-5 at V1)
  in the zone layout, with zeroed fold-padding lanes on the odd-length
  scales, so its ``feature_loss``, and with it ``loss_gen_all``, divides
  those maps' sums by a larger count: the JAX step's generator loss on an
  accelerator, where its ``'auto'`` means ``'fused_zoned'``. The port's
  ``'auto'`` is ``'fused_stack'`` on CUDA and ``'xla'`` on the CPU.
- ``disc_fused``: real and fake go through each sub-discriminator as one
  2B batch. On MSD scale 0 the D update then runs one spectral power
  iteration for both halves where the unfused step runs two, so the step
  differs from the unfused one from the D update on, as the JAX step does.

Parallelism (``make_train_step(h, mesh=)``): data parallel over the mesh's
``'data'`` axis. Each rank's batch is its rows of the logical batch
(``parallel.mesh.shard_batch``); the step runs under
``parallel.mesh.data_parallel_rows``, so the MSD's fused stack takes its
batch-sharded form on those rows. Every loss is a mean over rows, so the
mean of the ranks' gradients, taken once after each backward
(``parallel.mesh.reduce_gradients``), is the gradient of the logical batch,
and the metrics are the means over ranks. With ``state_shardings``
(``parallel.mesh.tensor_parallel_shardings``) each parameter the rule splits
over ``'model'``, and its AdamW moments, is held as this rank's slice
(:func:`shard_train_state`): the slices are gathered into the modules for
compute and each optimizer steps its slice. So the step's numbers are the
single-process step's on the logical batch, JAX's contract for a jitted
step under any sharding.

Entry points run on CUDA unless ``device='cpu'`` is passed.
"""

from __future__ import annotations

import contextlib
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
    # [(module parameter, this rank's slice, axis)] of a tensor-parallel state
    shards: list | None = None

    @property
    def spectral_msd(self) -> dict[str, torch.Tensor]:
        """The MSD's spectral-norm ``u`` buffers (scale 0), by state_dict name."""
        return {k: v for k, v in self.msd.named_buffers() if k.endswith("weight_u")}


def build_discriminators(h, generator: torch.Generator | None = None, mesh=None):
    """MPD/MSD with reference widths unless ``h`` overrides them
    (``mpd_periods``, ``mpd_channels``, ``msd_width``, ``msd_num_scales``,
    ``msd_conv_impl``, ``disc_compute_dtype``, ``disc_fused``; the module
    docstring says what the forms compute); ``mesh`` wires the MSD's fused
    stacks to their batch-sharded form."""
    dtype = compute_dtype(h.get("disc_compute_dtype"))
    fused = h.get("disc_fused", False)
    mpd = MultiPeriodDiscriminator(periods=tuple(h.get("mpd_periods", (2, 3, 5, 7, 11))),
                                   channels=tuple(h.get("mpd_channels", (32, 128, 512, 1024))),
                                   dtype=dtype, fused=fused, generator=generator)
    msd = MultiScaleDiscriminator(width=h.get("msd_width", 128),
                                  num_scales=h.get("msd_num_scales", 3), dtype=dtype,
                                  fused=fused, conv_impl=h.get("msd_conv_impl", "auto"),
                                  generator=generator, mesh=mesh)
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


def create_train_state(h, seed: int | None = None, device: str | torch.device | None = None,
                       mesh=None) -> VocoderTrainState:
    """Seeded generator, MPD, MSD and their AdamW pair on ``device`` (CUDA by
    default); ``mesh`` wires the MSD's fused stacks to their batch-sharded
    form (:func:`build_discriminators`)."""
    dev = resolve_device(device)
    gen_rng = torch.Generator().manual_seed(h["seed"] if seed is None else seed)
    generator = Generator(h, generator=gen_rng, dtype=compute_dtype(h.get("gen_compute_dtype")))
    mpd, msd = build_discriminators(h, generator=gen_rng, mesh=mesh)
    generator, mpd, msd = generator.to(dev), mpd.to(dev), msd.to(dev)
    opt_g, opt_d = make_optimizers(h, generator, mpd, msd)
    return VocoderTrainState(generator, mpd, msd, opt_g, opt_d, 0, dev)


def _as_tensor(value, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(value, dtype=torch.float32, device=device)


def shard_train_state(state: VocoderTrainState, shardings: dict, mesh) -> VocoderTrainState:
    """Hold each parameter ``shardings`` splits (``{name: axis or None}``
    from ``parallel.mesh.tensor_parallel_shardings``), and its AdamW
    moments, as this rank's slice over ``'model'``: the optimizers step the
    slices; the modules keep the gathered tensors for compute."""
    from hifigan_tpu_torch.parallel.mesh import shard_of

    names = {id(p): f"{top}.{n}" for top in ("generator", "mpd", "msd")
             for n, p in getattr(state, top).named_parameters()}
    shards = []
    for opt in (state.opt_g, state.opt_d):
        for group in opt.param_groups:
            held = []
            for p in group["params"]:
                axis = shardings.get(names[id(p)])
                if axis is None:
                    held.append(p)
                    continue
                s = torch.nn.Parameter(shard_of(p.detach(), axis, mesh).clone())
                moments = opt.state.pop(p, {})
                opt.state[s] = {k: shard_of(v, axis, mesh).clone()
                                if torch.is_tensor(v) and v.shape == p.shape else v
                                for k, v in moments.items()}
                shards.append((p, s, axis))
                held.append(s)
            group["params"] = held
    state.shards = shards
    return state


def _step_optimizer(opt: torch.optim.Optimizer, params: list, state: VocoderTrainState,
                    mesh) -> None:
    """The one gradient reduction over the mesh, then ``opt.step()`` on the
    slices a tensor-parallel state holds and the gathered modules refreshed."""
    from hifigan_tpu_torch.parallel.mesh import gather_shards, reduce_gradients, shard_of

    reduce_gradients(params, mesh)
    ids = {id(q) for q in params}
    mine = [(p, s, axis) for p, s, axis in state.shards or () if id(p) in ids]
    for p, s, axis in mine:
        s.grad = shard_of(p.grad, axis, mesh).clone()
        p.grad = None
    opt.step()
    with torch.no_grad():
        for p, s, axis in mine:
            gather_shards(p.data, s.data, axis, mesh)


def make_train_step(h, mesh=None, state_shardings: dict | None = None):
    """(state, batch) -> (state, metrics); batch: {'audio': (B, T) float32,
    optional 'mel': (B, num_mels, F)}. Metrics stay on the device.

    ``mesh``: data parallel over ``'data'`` (the batch is this rank's rows;
    the metrics are the means over ranks; build the state with the same
    ``mesh``). ``state_shardings``: also tensor parallel over ``'model'``;
    a state not yet split is split on the first call
    (:func:`shard_train_state`)."""
    from hifigan_tpu_torch.parallel.mesh import all_mean, data_parallel_rows

    mel_cfg = MelConfig.from_hparams(h)
    mel_loss_cfg = MelConfig.from_hparams(h, fmax_key="fmax_for_loss")

    def step_fn(state: VocoderTrainState, batch: dict):
        if state_shardings is not None and state.shards is None:
            shard_train_state(state, state_shardings, mesh)
        with data_parallel_rows() if mesh is not None else contextlib.nullcontext():
            state, metrics = local_step(state, batch)
        names = list(metrics)
        return state, dict(zip(names, all_mean([metrics[k] for k in names], mesh)))

    def local_step(state: VocoderTrainState, batch: dict):
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
        d_params = [*state.mpd.parameters(), *state.msd.parameters()]
        _step_optimizer(state.opt_d, d_params, state, mesh)

        # generator update against the refreshed, frozen discriminators
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
        _step_optimizer(state.opt_g, list(state.generator.parameters()), state, mesh)

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


def train(a, h, device: str | torch.device | None = None, writer=None,
          mesh=None) -> VocoderTrainState:
    """The training loop: checkpoints every ``checkpoint_interval`` steps,
    stdout/summary scalars, validation mel error, audio and spectrogram
    figures (left out where ``utils/plotting.available()`` is false). ``a``
    carries the CLI surface (checkpoint_path, training_epochs, *_interval,
    fine_tuning, input_* paths). ``mesh``: data parallel; each rank reads
    ``batch_size / data`` rows a step (a disjoint strided share of one
    order drawn from the seed and the epoch; every rank takes the same
    number of steps), and rank 0 alone prints, validates and writes
    checkpoints and summaries."""
    from hifigan_tpu_torch.data.meldataset import MelDataset, get_dataset_filelist
    from hifigan_tpu_torch.parallel.mesh import shard_batch
    from hifigan_tpu_torch.utils import plotting

    state = create_train_state(h, device=mesh.device if mesh is not None else device, mesh=mesh)
    n_data = 1 if mesh is None else mesh.shape["data"]
    index = 0 if mesh is None else mesh.coordinate("data")
    lead = mesh is None or mesh.rank == mesh.ranks.flat[0]
    if h["batch_size"] % n_data:
        raise ValueError(f"batch {h['batch_size']} not divisible by mesh axis 'data' ({n_data})")
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

    train_step = make_train_step(h, mesh=mesh)
    eval_step = make_eval_step(h)
    for epoch in range(max(0, last_epoch), a.training_epochs):
        lr = h["learning_rate"] * (h["lr_decay"] ** epoch)
        set_learning_rate(state.opt_g, lr)
        set_learning_rate(state.opt_d, lr)
        t_epoch = time.time()
        for batch in trainset.batches(h["batch_size"] // n_data, process_index=index,
                                      process_count=n_data, epoch=epoch):
            batch.pop("filenames", None)
            batch = shard_batch(batch, mesh)
            t0 = time.time()
            state, metrics = train_step(state, batch)
            steps = state.step
            if not lead:
                continue
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
                        if plotting.available():
                            mel_hat = log_mel_spectrogram(y_hat[:1], MelConfig.from_hparams(h))
                            writer.add_figure(f"generated/y_hat_spec_{n}",
                                              plotting.plot_spectrogram(mel_hat[0].cpu().numpy()),
                                              steps)
                    n += 1
                if n:
                    val_err /= n
                    print(f"Steps: {steps}, Validation Mel-Spec. Error: {val_err:.4f}")
                    if writer is not None:
                        writer.add_scalar("validation/mel_spec_error", val_err, steps)
        print(f"Epoch {epoch + 1} took {time.time() - t_epoch:.1f}s")
    return state
