"""Standalone label-bias sniffer trainer (port of ``hifigan_tpu/distill/sniffer.py``).

Sniffers are classifier ensembles that predict the *other* groups' labels
from one group's labels (one-hot encoded): a bias detector. The loss treats
the sniffer's softmax outputs as the logits of a cross-entropy, as the
reference does (:func:`cross_entropy_as_logits`). The optimizer is the
distill trainer's AdamW-amsgrad (:class:`~hifigan_tpu_torch.distill.train.AmsGradW`)
at ``learning_rate * lr_decay**step``.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from hifigan_tpu_torch.distill.losses import recursive_loss
from hifigan_tpu_torch.distill.train import AmsGradW
from hifigan_tpu_torch.dsl.module import ConfigurableModule, tree_map
from hifigan_tpu_torch.dsl.static_configs import generate_sniffers_configs_by_example


def generate_sniffers_by_example(example_item, cache_hook=lambda k, x: x(), layers=(),
                                 one_hot=True) -> dict[str, ConfigurableModule]:
    """One sniffer module (unbuilt) per label group of ``example_item``."""
    cfgs = generate_sniffers_configs_by_example(example_item, layers=list(layers), one_hot=one_hot)
    return {key: ConfigurableModule(cache_hook(key, lambda c=cfg: c)) for key, cfg in cfgs.items()}


def cross_entropy_as_logits(x: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """torch CrossEntropyLoss(input=x, target) with x already softmaxed, the
    reference's exact computation. x: (B, T, C); target: (B, T)."""
    log_z = torch.logsumexp(x, dim=-1)
    picked = torch.gather(x, -1, target.long()[..., None])[..., 0]
    return torch.mean(log_z - picked)


@dataclasses.dataclass
class SnifferTrainState:
    step: int
    sniffer: ConfigurableModule
    optimizer: AmsGradW


def _labels(tree, device):
    return tree_map(lambda a: torch.as_tensor(np.asarray(a) if not torch.is_tensor(a) else a,
                                              device=device).long(), tree)


class LabelBiasSnifferTrainer:
    def __init__(self, sniffer: ConfigurableModule, sniffer_key: str, config: dict | None = None):
        config = config or {"learning_rate": 0.0001, "lr_decay": 0.9999, "adam_b1": 0.8,
                            "adam_b2": 0.99}
        self.sniffer = sniffer
        self.sniffer_key = sniffer_key
        self.lr = config["learning_rate"]
        self.lr_decay = config["lr_decay"]
        self.b1, self.b2 = config["adam_b1"], config["adam_b2"]

    def create_state(self, example_labels: dict, seed: int = 0, build: bool = True,
                     device=None) -> SnifferTrainState:
        """The train state; with ``build`` the sniffer's parameters are drawn
        (seeded, on the CPU) from ``example_labels`` (this group's labels),
        else used as loaded; then moved to ``device`` (default: where they are)."""
        if build:
            self.sniffer.build(_labels(example_labels, "cpu"),
                               generator=torch.Generator().manual_seed(seed))
        if device is not None:
            self.sniffer.to(device)
        return SnifferTrainState(0, self.sniffer, AmsGradW(list(self.sniffer.parameters()),
                                                           self.b1, self.b2,
                                                           learning_rate=self.lr))

    def _loss(self, batch: dict):
        dev = next(self.sniffer.parameters()).device
        labels = _labels(batch["time_labels"], dev)
        preds = self.sniffer(labels[self.sniffer_key])["mean"]
        return recursive_loss(cross_entropy_as_logits, preds, labels), preds

    def make_train_step(self):
        """``step(state, batch) -> (state, {'loss': loss})``: one update at
        ``lr * lr_decay**step`` (step counted after the increment)."""

        def step(state: SnifferTrainState, batch: dict):
            opt = state.optimizer
            for p in opt.params:
                p.grad = None
            loss, _ = self._loss(batch)
            loss.backward()
            grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in opt.params]
            state.step += 1
            lr = float(np.float32(self.lr) * np.float32(self.lr_decay) ** np.float32(state.step))
            opt.step(grads, lr)
            for p in opt.params:
                p.grad = None
            return state, {"loss": loss.detach()}

        return step

    def make_eval_step(self):
        """``eval(state, batch) -> ({'loss': loss}, predictions)``."""

        @torch.no_grad()
        def eval_fn(state: SnifferTrainState, batch: dict):
            loss, preds = self._loss(batch)
            return {"loss": loss}, preds

        return eval_fn
