"""GAN training: ``make_train_step`` at B = ``batch`` x ``segment`` samples.

Set-up makes the weights (upstream names, weight norm and MSD scale 0's
spectral norm) and a pool of ``pool_batches`` batches of seeded audio with
their log-mels on the device, builds the port's train state on those
weights and drives it through its first ``check_steps`` steps on the
pool's first batches, all of whose rows differ, through the window's own
call. Those steps' readings are kept: each step's losses, the first
gradient of every leaf as its optimizer got it (worked out from AdamW's
first moment after step 1: m = (1 - b1) g), and every leaf's change after
the last of them. The same state then runs the window, one step after
another over the pool, each step waited for. Once the window has closed the
reference follows the same steps from the same weights and batches.

Numbers compared (leaf gaps by :func:`gaps`): ``loss_gap``, the worst
relative gap of a step's generator or discriminator loss; ``grad_norm_gap``,
the median leaf's gap between its first-gradient norm and the reference's;
``update_norm_gap``, the worst leaf's gap between its change over the steps
and the reference's. A leaf's gap is taken against the reference's norm of
that leaf or the median leaf's, whichever is larger. Leaves whose reference
gradient is under a thousandth of the median leaf's move by round-off alone
and are left out of the change. The worst leaf's gradient gap swings from
seed to seed with the rounding of one small leaf (a 32-channel stage's
``weight_g`` or bias), so the gradient is held by its median leaf; ``worst``
keeps the three worst leaves of each after a check.
"""

from __future__ import annotations

import statistics
import time

import torch

from port_bench import inputs
from port_bench.harness import Reading, Unit, Window
from port_bench.reference import discriminators, generator
from port_bench.reference.mel import log_mel
from port_bench.reference.numerics import BY_NAME, FP32, no_tf32
from port_bench.reference.train_step import new_state, train_step

WEIGHTS, DATA = 0, 1
LOSSES = ("loss_gen_all", "loss_disc_all")
ROUND_OFF_LEAF = 1e-3  # below this share of the median leaf's gradient, a leaf is not compared


def _strip(d: dict, prefix: str) -> dict:
    return {k[len(prefix):]: v for k, v in d.items() if k.startswith(prefix)}


class PortSystem:
    """The port's train state on the given weights, and its step."""

    def __init__(self, run, params: dict, buffers: dict):
        from hifigan_tpu_torch.models import Generator
        from hifigan_tpu_torch.train import vocoder

        h, dev = run.h, run.device
        with torch.device(dev):
            gen = Generator(h, dtype=vocoder.compute_dtype(h.get("gen_compute_dtype")))
            mpd, msd = vocoder.build_discriminators(h)
        state_dict = {**params, **buffers}
        gen.load_state_dict(_strip(state_dict, "generator."))
        mpd.load_state_dict(_strip(state_dict, "mpd."))
        msd.load_state_dict(_strip(state_dict, "msd."))
        opt_g, opt_d = vocoder.make_optimizers(h, gen, mpd, msd)
        self.state = vocoder.VocoderTrainState(gen, mpd, msd, opt_g, opt_d, 0, dev)
        self.step_fn = vocoder.make_train_step(h)
        self.b1 = h["adam_b1"]

    def named(self) -> dict:
        s = self.state
        return {f"{top}.{n}": p for top, m in (("generator", s.generator), ("mpd", s.mpd),
                                                ("msd", s.msd)) for n, p in m.named_parameters()}

    def step(self, batch: dict) -> dict:
        self.state, metrics = self.step_fn(self.state, batch)
        return {k: metrics[k] for k in LOSSES}

    def first_grad_norms(self) -> dict:
        """Each leaf's step-1 gradient norm from its optimizer's first moment."""
        out = {}
        for name, p in self.named().items():
            for opt in (self.state.opt_g, self.state.opt_d):
                if p in opt.state:
                    out[name] = float(opt.state[p]["exp_avg"].norm() / (1.0 - self.b1))
        return out


class ControlSystem:
    """The reference step in the control precision, in the program's place."""

    def __init__(self, run, params: dict, buffers: dict):
        self.h, self.num = run.h, BY_NAME[run.h["train_control"]]
        self.state = new_state(run.h, params, buffers)
        self.grads: dict = {}

    def named(self) -> dict:
        return self.state.params

    def step(self, batch: dict) -> dict:
        losses, grads = train_step(self.h, self.state, batch["audio"], batch["mel"], self.num)
        if not self.grads:
            self.grads = {k: float(g.norm()) for k, g in grads.items()}
        return losses

    def first_grad_norms(self) -> dict:
        return self.grads


def change_norms(named: dict, start: dict) -> dict:
    return {k: float((p.detach() - start[k]).norm()) for k, p in named.items()}


def gaps(got: dict, want: dict, skip=frozenset()) -> dict:
    """Each leaf's |got - want| / max(want, the median leaf's want)."""
    keys = [k for k in want if k not in skip]
    floor = statistics.median(want[k] for k in keys)
    return {k: abs(got.get(k, float("inf")) - want[k]) / max(want[k], floor, 1e-30)
            for k in keys}


class Driver:
    worst: dict  # after check(): the three worst leaves of each leaf-wise number

    def __init__(self, run):
        self.run = run
        h, mix, dev = run.h, run.mix, run.device
        b, t = mix["batch"], mix["segment"]
        gen_w = inputs.generator_for(run.seed, dev, WEIGHTS)
        g_params, _ = inputs.conv_weights(generator.conv_shapes(h), gen_w, dev)
        d_params, self.buffers = inputs.conv_weights(discriminators.conv_shapes(h), gen_w, dev)
        self.params = {**{f"generator.{k}": v for k, v in g_params.items()}, **d_params}
        gen_x = inputs.generator_for(run.seed, dev, DATA)
        audio = inputs.synthetic_audio(mix["pool_batches"] * b, t, h["sampling_rate"], gen_x, dev)
        mel = log_mel(h, audio)
        self.batches = [{"audio": audio[i * b:(i + 1) * b], "mel": mel[i * b:(i + 1) * b]}
                        for i in range(mix["pool_batches"])]
        cls = ControlSystem if run.program == "control" else PortSystem
        self.system = cls(run, self.params, self.buffers)
        self.losses = []
        for k in range(mix["check_steps"]):
            self.losses.append({n: float(v) for n, v in self.system.step(self.batches[k]).items()})
            if k == 0:
                self.grad_norms = self.system.first_grad_norms()
        self.change = change_norms(self.system.named(), self.params)
        self.next = mix["check_steps"]

    def window(self, seconds: float) -> Window:
        run, units = self.run, []
        b, t = run.mix["batch"], run.mix["segment"]
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < seconds:
            batch = self.batches[self.next % len(self.batches)]
            self.next += 1
            with run.span("port_bench.step"):
                start = time.perf_counter()
                with run.span("program call"):
                    self.system.step(batch)
                called = time.perf_counter()
                with run.span("wait for the output"):
                    run.sync()
            units.append(Unit(start, time.perf_counter(), 0.0, called - start,
                              {"train_steps": 1, "batch": b, "segment": t}))
        t1 = units[-1].end if units else time.perf_counter()
        return Window(units, t0, t1, len(units), 0)

    def release(self) -> None:
        self.system = None

    def check(self, limits: dict) -> list:
        with no_tf32():
            ref = new_state(self.run.h, self.params, self.buffers)
            ref_losses = []
            for k in range(len(self.losses)):
                batch = self.batches[k]
                losses, grads = train_step(self.run.h, ref, batch["audio"], batch["mel"], FP32)
                ref_losses.append({n: float(v) for n, v in losses.items()})
                if k == 0:
                    ref_grads = {n: float(g.norm()) for n, g in grads.items()}
                del grads
        ref_change = change_norms(ref.params, self.params)
        median = statistics.median(ref_grads.values())
        round_off = {k for k, v in ref_grads.items() if v < ROUND_OFF_LEAF * median}
        loss_gap = max(abs(got[n] - want[n]) / max(abs(want[n]), 1e-30)
                       for got, want in zip(self.losses, ref_losses) for n in LOSSES)
        grad = gaps(self.grad_norms, ref_grads)
        update = gaps(self.change, ref_change, round_off)
        self.worst = {name: sorted(g.items(), key=lambda kv: -kv[1])[:3]
                      for name, g in (("grad_norm_gap", grad), ("update_norm_gap", update))}
        return [Reading("loss_gap", loss_gap, limits["loss_gap"]),
                Reading("grad_norm_gap", statistics.median(grad.values()),
                        limits["grad_norm_gap"]),
                Reading("update_norm_gap", max(update.values()), limits["update_norm_gap"])]
