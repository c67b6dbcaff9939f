"""Preemption handling (counterpart of ``sensorium_tpu/engine/preemption.py``).

A preemptible machine gets a SIGTERM before it is taken away; this turns
that warning into a clean exit:

* ``PreemptionHandler`` installs signal handlers (SIGTERM by default) that
  set a flag instead of killing the process;
* ``MouseModel.fit`` polls the flag between training steps, after
  validation and after the epoch's callbacks; when set, it saves the full
  train state (weights, EMA, optimizer moments, dropout generator, update
  count) through the atomic checkpoint writer and raises
  ``TrainingPreempted``;
* ``MouseModel.load_train_state`` then resumes: the interrupted epoch
  restarts, which the loader's ``(seed, epoch)`` sampling makes replay the
  same batches.
"""

from __future__ import annotations

import signal
from types import FrameType


class TrainingPreempted(Exception):
    """Raised by the fit loop after state was saved on a preemption signal."""

    def __init__(self, save_path):
        super().__init__(f"training preempted; train state saved to '{save_path}'")
        self.save_path = save_path


class PreemptionHandler:
    """Context manager that latches preemption signals into a flag."""

    def __init__(self, signals: tuple[int, ...] = (signal.SIGTERM,)):
        self.signals = signals
        self.triggered = False
        self._previous: dict[int, object] = {}

    def _on_signal(self, signum: int, frame: FrameType | None) -> None:
        self.triggered = True

    def __enter__(self) -> "PreemptionHandler":
        self.triggered = False
        for sig in self.signals:
            try:
                self._previous[sig] = signal.signal(sig, self._on_signal)
            except ValueError:
                # Not the main thread (e.g. under a test runner) — poll-only.
                pass
        return self

    def __exit__(self, *exc_info) -> None:
        for sig, previous in self._previous.items():
            signal.signal(sig, previous)
        self._previous.clear()
