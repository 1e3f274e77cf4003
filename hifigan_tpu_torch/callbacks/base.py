"""Callback framework for the training loops (port of
``hifigan_tpu/callbacks/base.py``).

The trainer is a plain host loop around one step function, so the callback
surface is the loop itself: a `TrainLoop` owns the train state, the log
dir, the TensorBoard writer (or None), and fires hooks. Hooks that restore
training state (checkpoint resume) assign ``loop.state``; the port's train
states hold their modules and optimizer tensors and are loaded in place.
``global_step`` is the state's ``step`` (a host int in the port, so reading
it never waits for the device).
"""

from __future__ import annotations

import os
from typing import Any, Callable, Iterable


class Callback:
    def on_init_end(self, loop: "TrainLoop") -> None: ...

    def on_step_start(self, loop: "TrainLoop") -> None: ...

    def on_step_end(self, loop: "TrainLoop", losses: Any) -> None: ...

    def on_validation_batch_end(self, loop: "TrainLoop", losses: Any, data: Any) -> None: ...

    def on_validation_end(self, loop: "TrainLoop") -> None: ...


class TrainLoop:
    """Host loop: batches -> step, with callbacks.

    ``save_state``/``load_state`` close over the trainer's checkpoint
    (de)serialisation; ``log_dir`` follows the reference's TensorBoard
    name/version directory contract (lightning_model.py:766-799).
    """

    def __init__(
        self,
        state: Any,
        step_fn: Callable,
        log_dir: str,
        callbacks: list[Callback] | None = None,
        writer: Any = None,
        save_state: Callable[[str, Any], None] | None = None,
        load_state: Callable[[str, Any], Any] | None = None,
    ) -> None:
        self.state = state
        self.step_fn = step_fn
        self.log_dir = log_dir
        self.callbacks = callbacks or []
        self.writer = writer
        self.save_state = save_state
        self.load_state = load_state
        self.checkpoint_dir = os.path.join(log_dir, "checkpoints")
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        self.stop_requested = False
        for cb in self.callbacks:
            cb.on_init_end(self)

    @property
    def global_step(self) -> int:
        return int(self.state.step)

    def fire(self, hook: str, *args: Any) -> None:
        for cb in self.callbacks:
            getattr(cb, hook)(self, *args)

    def run(
        self,
        batches: Iterable,
        *step_extras: Any,
        max_steps: int | None = None,
        make_extras: Callable[[int], tuple] | None = None,
    ) -> Any:
        for batch in batches:
            if self.stop_requested or (max_steps is not None and self.global_step >= max_steps):
                break
            self.fire("on_step_start")
            extras = make_extras(self.global_step) if make_extras else step_extras
            self.state, losses = self.step_fn(self.state, batch, *extras)
            self.fire("on_step_end", losses)
        return self.state

    def run_validation(self, eval_fn: Callable, batches: Iterable, *extras: Any) -> None:
        for batch in batches:
            losses, data = eval_fn(self.state, batch, *extras)
            self.fire("on_validation_batch_end", losses, data)
        self.fire("on_validation_end")
