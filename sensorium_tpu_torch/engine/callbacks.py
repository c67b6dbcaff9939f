"""Training callbacks (counterpart of ``sensorium_tpu/engine/callbacks.py``).

The callbacks of the fit loop: logging to ``log.txt``, ``log.csv`` and
``log.jsonl``, best-k checkpoints, early stopping and an epoch timer. The
learning rate is a schedule of the update count inside the train step, not
a callback.
"""

from __future__ import annotations

import csv
import json
import logging
import sys
import time
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

from sensorium_tpu_torch.engine.checkpoint import flush_pending_saves

_FORMAT = "%(asctime)s %(levelname)s %(message)s"


@dataclass
class EngineState:
    """What callbacks observe at epoch boundaries."""

    model: Any
    stage: str = "train"
    epoch: int = 0
    global_epoch: int = 0
    metrics: dict[str, float] = field(default_factory=dict)
    logger: logging.Logger = field(default_factory=lambda: logging.getLogger("sensorium"))
    stopped: bool = False


class Callback:
    def epoch_start(self, state: EngineState) -> None:
        pass

    def epoch_complete(self, state: EngineState) -> None:
        pass

    def fit_complete(self, state: EngineState) -> None:
        """Called once when fit() ends, normally or on an error."""
        pass


def _has_file_handler(logger: logging.Logger, path) -> bool:
    return any(
        isinstance(h, logging.FileHandler) and Path(getattr(h, "baseFilename", "")) == Path(path).resolve()
        for h in logger.handlers
    )


def build_logger(log_path: Path | None = None, append: bool = True) -> logging.Logger:
    """The shared 'sensorium' logger, with a stdout handler and optionally a
    file handler, each added only if an equal one is not there already (the
    logger is process-wide; no handler is ever removed here)."""
    logger = logging.getLogger("sensorium")
    logger.setLevel(logging.INFO)
    formatter = logging.Formatter(_FORMAT)
    if not any(type(h) is logging.StreamHandler and getattr(h, "stream", None) is sys.stdout
               for h in logger.handlers):
        stream = logging.StreamHandler(sys.stdout)
        stream.setFormatter(formatter)
        logger.addHandler(stream)
    if log_path is not None and not _has_file_handler(logger, log_path):
        handler = logging.FileHandler(log_path, mode="a" if append else "w")
        handler.setFormatter(formatter)
        logger.addHandler(handler)
    return logger


class LoggingToFile(Callback):
    """Mirror the log lines of a fit into ``log.txt``."""

    def __init__(self, file_path, append: bool = True):
        self.file_path = Path(file_path)
        self.append = append
        self._handler: logging.FileHandler | None = None

    def epoch_start(self, state: EngineState) -> None:
        self.file_path.parent.mkdir(parents=True, exist_ok=True)
        if not _has_file_handler(state.logger, self.file_path):
            handler = logging.FileHandler(self.file_path, mode="a" if self.append else "w")
            handler.setFormatter(logging.Formatter(_FORMAT))
            state.logger.addHandler(handler)
            self._handler = handler

    def fit_complete(self, state: EngineState) -> None:
        # Detach the handler this callback attached (and only that one), or
        # a later fit's lines would land in this file too.
        if self._handler is not None:
            state.logger.removeHandler(self._handler)
            self._handler.close()
            self._handler = None


class LoggingToCSV(Callback):
    """Append one metrics row per epoch to ``log.csv``.

    Columns stay aligned with the header when the metric set changes: absent
    keys are left empty, and a row with new keys rewrites the file once
    under the union header.
    """

    def __init__(self, file_path, append: bool = True):
        self.file_path = Path(file_path)
        self.append = append
        self._initialized = False
        self._fieldnames: list[str] | None = None

    def epoch_complete(self, state: EngineState) -> None:
        self.file_path.parent.mkdir(parents=True, exist_ok=True)
        row = {"epoch": state.global_epoch, "stage": state.stage, **state.metrics}
        use_existing = self.file_path.exists() and (self.append or self._initialized)
        if self._fieldnames is None:
            self._fieldnames = []
            if use_existing:
                with open(self.file_path, newline="") as handle:
                    self._fieldnames = list(csv.DictReader(handle).fieldnames or [])
        new_keys = [key for key in row if key not in self._fieldnames]
        if new_keys:
            self._fieldnames = self._fieldnames + new_keys
            old_rows: list[dict] = []
            if use_existing:
                with open(self.file_path, newline="") as handle:
                    old_rows = list(csv.DictReader(handle))
            with open(self.file_path, "w", newline="") as handle:
                writer = csv.DictWriter(handle, fieldnames=self._fieldnames, restval="")
                writer.writeheader()
                writer.writerows(old_rows)
                writer.writerow(row)
        else:
            with open(self.file_path, "a", newline="") as handle:
                csv.DictWriter(handle, fieldnames=self._fieldnames, restval="").writerow(row)
        self._initialized = True


class LoggingToJSONL(Callback):
    """Append one JSON record per epoch to ``log.jsonl``: the CSV row's keys
    plus a wall-clock ``time``, one flushed line each."""

    def __init__(self, file_path, append: bool = True):
        self.file_path = Path(file_path)
        self._initialized = False
        self.append = append

    def epoch_complete(self, state: EngineState) -> None:
        self.file_path.parent.mkdir(parents=True, exist_ok=True)
        record = {
            "time": time.time(),
            "epoch": state.global_epoch,
            "stage": state.stage,
            **{k: float(v) for k, v in state.metrics.items()},
        }
        mode = "a" if (self.append or self._initialized) else "w"
        with open(self.file_path, mode) as handle:
            handle.write(json.dumps(record) + "\n")
            handle.flush()
        self._initialized = True


class Checkpoint(Callback):
    """Best-k checkpoints of the eval (EMA) weights.

    After each epoch that has the ``monitor`` metric, saves the model as
    ``file_format`` (fields: ``epoch``, the metrics) and keeps the
    ``max_saves`` best by ``monitor``; ``better`` is "min", "max" or "auto"
    (min for a loss). With ``save_train_state`` it also writes the resume
    state to ``train_state_name``; ``save_model=False`` writes only that.
    ``background=True`` moves serialization and the writes off the loop.
    On a process of a mesh that writes no single-file checkpoint (not the
    first process: ``MouseModel.writes_files``) it only joins the saves that
    are collectives (a gather under a model axis, a ``.orbax`` state) and
    keeps no files.
    """

    def __init__(
        self,
        save_dir,
        file_format: str = "model-{epoch:03d}-{val_corr:.6f}.ckpt",
        max_saves: int = 1,
        monitor: str = "val_corr",
        better: str = "max",
        save_train_state: bool = True,
        background: bool = False,
        train_state_name: str = "train_state.ckpt",
        save_model: bool = True,
    ):
        # Anything else ("Max", "maximize") would sort the wrong way and keep the worst.
        if better not in ("min", "max", "auto"):
            raise ValueError(f"better must be min/max/auto, got {better!r}")
        if better == "auto":
            better = "min" if "loss" in monitor else "max"
        self.save_dir = Path(save_dir)
        self.file_format = file_format
        self.max_saves = max_saves
        self.monitor = monitor
        self.better = better
        self.save_train_state = save_train_state
        self.train_state_name = train_state_name
        self.save_model = save_model
        self.background = background
        self._saved: list[tuple[float, Path]] = []

    def epoch_complete(self, state: EngineState) -> None:
        if self.monitor not in state.metrics:
            return
        score = float(state.metrics[self.monitor])
        writes = getattr(state.model, "writes_files", True)
        if writes:
            self.save_dir.mkdir(parents=True, exist_ok=True)
        fields = {"epoch": state.global_epoch, self.monitor: score, **state.metrics}
        file_path = self.save_dir / self.file_format.format(**fields)
        if self.save_model:
            state.model.save(file_path, background=self.background)
            if writes:
                state.logger.info(f"Model saved to '{file_path}'")
        if self.save_train_state:
            state.model.save_train_state(
                self.save_dir / self.train_state_name,
                extra={"epoch": state.global_epoch, self.monitor: score},
                background=self.background,
            )
        if not self.save_model or not writes:
            return
        self._saved.append((score, file_path))
        self._saved.sort(key=lambda item: item[0], reverse=self.better == "max")
        while len(self._saved) > self.max_saves:
            _, worst_path = self._saved.pop()
            if self.background and worst_path == file_path:
                # This epoch's own save is the worst and may still be in
                # flight: join it, or its rename would bring the file back.
                flush_pending_saves()
            worst_path.unlink(missing_ok=True)
            state.logger.info(f"Model removed '{worst_path}'")


class EarlyStopping(Callback):
    """Stop fitting after ``patience`` epochs without improvement of
    ``monitor``; ``better`` is "min", "max" or "auto" (min for a loss)."""

    def __init__(self, monitor: str = "val_loss", patience: int = 1, better: str = "auto"):
        if better not in ("min", "max", "auto"):
            raise ValueError(f"better must be min/max/auto, got {better!r}")
        if better == "auto":
            better = "min" if "loss" in monitor else "max"
        self.monitor = monitor
        self.patience = patience
        self.better = better
        self.best: float | None = None
        self.wait = 0

    def epoch_complete(self, state: EngineState) -> None:
        if self.monitor not in state.metrics:
            return
        score = float(state.metrics[self.monitor])
        improved = (
            self.best is None
            or (self.better == "max" and score > self.best)
            or (self.better == "min" and score < self.best)
        )
        if improved:
            self.best = score
            self.wait = 0
            return
        self.wait += 1
        if self.wait >= self.patience:
            state.stopped = True
            state.logger.info(
                f"Early stopping: no {self.monitor} improvement over {self.best:.6g} for {self.wait} epochs "
                f"(patience {self.patience})"
            )


class Timer(Callback):
    """Each epoch's wall time, as the metric ``epoch_time``."""

    def __init__(self):
        self._start = 0.0

    def epoch_start(self, state: EngineState) -> None:
        self._start = time.perf_counter()

    def epoch_complete(self, state: EngineState) -> None:
        state.metrics["epoch_time"] = round(time.perf_counter() - self._start, 3)
