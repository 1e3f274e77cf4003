"""Interval loss aggregation + TensorBoard scalar logging (port of
``hifigan_tpu/callbacks/logging.py``).

Nested loss dicts are summed per loop type over an interval, then reset
callbacks fire (logging, best-checkpointing); scalar tags are depth-ranked
(`train_losses_2/generator`).

The sums stay on the device: a step's loss tree (0-d tensors) is added
into float32 running sums where its tensors are, and the host reads them
once per interval, at the reset, as one stacked copy. The JAX callback
fetches every step's tree to the host and sums there in float32 (numpy
scalars), which gives the same values: the same float32 adds in the same
order.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any

import torch

from hifigan_tpu_torch.callbacks.base import Callback, TrainLoop


def rank(prefix: str) -> str:
    """Depth-ranked scalar tag (reference logging_utils.py:1-4)."""
    elements = prefix.split("/")
    elements[0] = f"{elements[0]}_{len(elements)}"
    return "/".join(elements)


def _flatten(tree: Any, out: list) -> Any:
    """Leaves of a nested dict/list/tuple into ``out``; returns the
    structure with each leaf replaced by its position."""
    if isinstance(tree, Mapping):
        return {k: _flatten(v, out) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_flatten(v, out) for v in tree]
    out.append(tree)
    return len(out) - 1


def _unflatten(structure: Any, values: list) -> Any:
    if isinstance(structure, Mapping):
        return {k: _unflatten(v, values) for k, v in structure.items()}
    if isinstance(structure, list):
        return [_unflatten(v, values) for v in structure]
    return values[structure]


def _as_tensor(x: Any) -> torch.Tensor:
    return x.detach().float() if torch.is_tensor(x) else torch.tensor(float(x))


class OutputSumResetCallback:
    def on_sum_reset(self, loop, batch_type, sums, amounts, global_step) -> None:
        raise NotImplementedError


class _DeviceSum:
    """Running float32 sums of a loss tree, kept where its tensors are."""

    def __init__(self, losses: Any):
        leaves: list = []
        self.structure = _flatten(losses, leaves)
        self.sums = [_as_tensor(x).clone() for x in leaves]

    def add(self, losses: Any) -> None:
        leaves: list = []
        _flatten(losses, leaves)
        torch._foreach_add_(self.sums, [_as_tensor(x) for x in leaves])

    def read(self) -> Any:
        """The sums as a tree of Python floats: one copy to the host."""
        if not self.sums:
            return _unflatten(self.structure, [])
        host = torch.stack([s.reshape(()) for s in self.sums]).cpu().tolist()
        return _unflatten(self.structure, host)


class OutputSumCallback(Callback):
    """Accumulate nested loss dicts per loop type; fire resets on interval
    (reference output_sum_callback.py:10-83)."""

    def __init__(self, reset_intervals: dict[str, int],
                 reset_callbacks: list[OutputSumResetCallback] | None = None):
        self.reset_intervals = reset_intervals
        self.reset_callbacks = reset_callbacks or []
        self.loss_sums: dict[str, _DeviceSum | None] = {key: None for key in reset_intervals}
        self.loss_amounts = {key: 0 for key in reset_intervals}
        self.last_reset_steps = {key: -1 for key in reset_intervals}

    def _accumulate(self, batch_type: str, losses: Any) -> None:
        if self.loss_sums[batch_type] is None:
            self.loss_sums[batch_type] = _DeviceSum(losses)
        else:
            self.loss_sums[batch_type].add(losses)
        self.loss_amounts[batch_type] += 1

    def on_step_end(self, loop: TrainLoop, losses: Any) -> None:
        self._accumulate("train", losses)
        step = loop.global_step
        for batch_type, interval in self.reset_intervals.items():
            if (
                step % interval == 0
                and self.last_reset_steps[batch_type] != step
                and self.loss_sums[batch_type] is not None
            ):
                self.on_sum_reset(
                    loop, batch_type, self.loss_sums[batch_type].read(),
                    self.loss_amounts[batch_type], step,
                )
                self.last_reset_steps[batch_type] = step
                self.loss_sums[batch_type] = None
                self.loss_amounts[batch_type] = 0

    def on_validation_batch_end(self, loop: TrainLoop, losses: Any, data: Any) -> None:
        if "validation" in self.loss_sums:
            self._accumulate("validation", losses)

    def on_validation_end(self, loop: TrainLoop) -> None:
        if self.loss_sums.get("validation") is not None:
            self.on_sum_reset(
                loop, "validation", self.loss_sums["validation"].read(),
                self.loss_amounts["validation"], loop.global_step,
            )
            self.loss_sums["validation"] = None
            self.loss_amounts["validation"] = 0

    def on_sum_reset(self, loop, batch_type, sums, amounts, global_step) -> None:
        for cb in self.reset_callbacks:
            cb.on_sum_reset(loop, batch_type, sums, amounts, global_step)


class OutputLoggingCallback(OutputSumResetCallback):
    """Walk nested sums -> depth-ranked TB scalars (output_logging_callback.py)."""

    def on_sum_reset(self, loop, batch_type, sums, amounts, global_step) -> None:
        if loop.writer is None:
            return
        self._log(loop.writer, f"{batch_type}_losses", sums, amounts, global_step)

    def _log(self, writer, prefix, sums, amounts, step) -> None:
        if isinstance(sums, Mapping):
            for key, value in sums.items():
                self._log(writer, f"{prefix}/{key}", value, amounts, step)
        elif isinstance(sums, (list, tuple)):
            for i, value in enumerate(sums):
                self._log(writer, f"{prefix}/{i}", value, amounts, step)
        else:
            writer.add_scalar(rank(prefix), float(sums) / amounts, step)
