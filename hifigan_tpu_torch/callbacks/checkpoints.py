"""Checkpoint callbacks (port of ``hifigan_tpu/callbacks/checkpoints.py``):
`latest` every N steps with auto-resume at init, `step_N` history
snapshots, and best-validation tracking persisted to best_score.yaml,
written and read with ``utils/caching.dump_yaml``/``load_yaml`` (the text
``yaml.dump`` writes, so either side reads the other's file)."""

from __future__ import annotations

import os
from collections.abc import Mapping
from pathlib import Path

from hifigan_tpu_torch.callbacks.base import Callback, TrainLoop
from hifigan_tpu_torch.callbacks.logging import OutputSumResetCallback
from hifigan_tpu_torch.utils.caching import dump_yaml, load_yaml


class ContinuousCheckpointCallback(Callback):
    """Save `checkpoints/latest` every N steps; auto-resume from it at init
    (reference continuous_checkpoint_callback.py:15-23)."""

    def __init__(self, steps_interval: int = 100):
        self.steps_interval = steps_interval

    def _latest(self, loop: TrainLoop) -> str:
        return os.path.join(loop.checkpoint_dir, "latest")

    def on_init_end(self, loop: TrainLoop) -> None:
        path = self._latest(loop)
        if Path(path).exists() and loop.load_state is not None:
            loop.state = loop.load_state(path, loop.state)
            print(f"Resumed from {path} at step {loop.global_step}")

    def on_step_end(self, loop: TrainLoop, losses) -> None:
        if loop.global_step % self.steps_interval == 0 and loop.save_state is not None:
            loop.save_state(self._latest(loop), loop.state)


class HistoryCheckpointCallback(Callback):
    """Save `checkpoints/step_N` every N steps (history_checkpoint_callback.py)."""

    def __init__(self, steps_interval: int = 5000):
        self.steps_interval = steps_interval

    def on_step_end(self, loop: TrainLoop, losses) -> None:
        if loop.global_step % self.steps_interval == 0 and loop.save_state is not None:
            loop.save_state(
                os.path.join(loop.checkpoint_dir, f"step_{loop.global_step}"), loop.state
            )


class BestCheckpointCallback(OutputSumResetCallback, Callback):
    """Track the best validation loss-sum; persist `checkpoints/best` +
    best_score.yaml (reference best_checkpoint_callback.py:18-47)."""

    def __init__(self, checkpoint_threshold: float = float("inf")):
        self.current_best = checkpoint_threshold
        self.best_score_path: str | None = None

    def on_init_end(self, loop: TrainLoop) -> None:
        self.best_score_path = os.path.join(loop.checkpoint_dir, "best_score.yaml")
        if Path(self.best_score_path).exists():
            self.current_best = load_yaml(Path(self.best_score_path).read_text())

    def on_sum_reset(self, loop, batch_type, sums, amounts, global_step) -> None:
        if batch_type != "validation":
            return
        new_avg = self._avg_total(sums, amounts)
        if new_avg < self.current_best:
            self.current_best = float(new_avg)
            if loop.save_state is not None:
                loop.save_state(os.path.join(loop.checkpoint_dir, "best"), loop.state)
            Path(self.best_score_path).write_text(dump_yaml(self.current_best))

    def _avg_total(self, sums, amounts) -> float:
        if isinstance(sums, Mapping):
            return sum(self._avg_total(v, amounts) for v in sums.values())
        if isinstance(sums, (list, tuple)):
            return sum(self._avg_total(v, amounts) for v in sums)
        return float(sums) / amounts
