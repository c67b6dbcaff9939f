"""What every traffic driver shares. A traffic file's ``driver`` names a
module ``drivers/<driver>.py``, found by name, whose ``Driver`` subclasses
``BaseDriver`` here; the rest of the traffic file says with what it drives
the program.

A driver sets up, runs its window, frees the program's state, then works out
its answers again with the plain reference (``check``) and, for the
calibration, with the control and the faults put in the program's place
(``faults``).
"""

from __future__ import annotations

import gc
import time

import torch

from benchmark.harness import spec
from benchmark.harness.weights import calibrate_bn, make_weights
from benchmark.reference import model as ref


def nn_cfg(params: dict) -> dict:
    return dict(params["nn_module"][1])


def free_device() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


class BaseDriver:
    """``devices``: the cards the cell asks for (``chips`` of them), or the
    CPU in the tests; a one-card driver runs on the first."""

    def __init__(self, cell: spec.Cell, seed: int, devices: list[torch.device]):
        self.cell, self.seed, self.devices, self.device = cell, seed, devices, devices[0]
        self.config, self.traffic = cell.config, cell.traffic
        self.params = spec.argus_params(self.config)
        self.cfg = nn_cfg(self.params)
        self.frame_stack = self.params["frame_stack"]
        width, height = self.params["inputs_processor"][1]["size"]
        self.canvas = (height, width)
        self.phases: dict = {}

    def phase(self, name: str, start: float) -> float:
        now = time.perf_counter()
        self.phases[name] = round(now - start, 3)
        return now

    def trained_weights(self, cfg: dict, stream: str) -> dict:
        """Weights from the seed with BN statistics that fit their inputs, as
        a trained model's do (``weights.calibrate_bn``), kept on the host for
        the reference."""
        ref.set_exact_float32()
        weights = calibrate_bn(make_weights(cfg, self.seed, self.device, stream), cfg, self.frame_stack,
                               self.canvas, self.traffic["video"], self.seed, self.device)
        return {n: t.cpu() for n, t in weights.items()}

    def setup(self) -> None:
        raise NotImplementedError

    def window(self, deadline: float) -> dict:
        """Drive the program until ``deadline`` (host clock); the counts of
        the work done, with ``attempted``."""
        raise NotImplementedError

    def failed(self, counts_: dict) -> int:
        raise NotImplementedError

    def work(self, counts_: dict, rates: dict | None) -> dict:
        """The window's work by ``work/counts.py``: ``flops`` and, with a
        card's peaks, ``dw_least_s``."""
        raise NotImplementedError

    def free(self) -> None:
        raise NotImplementedError

    def check(self) -> tuple[dict, dict]:
        """(numbers compared, details) against the plain reference."""
        raise NotImplementedError

    def faults(self) -> dict:
        """``{name: numbers}`` of the control and each planted fault, against
        the reference ``check`` worked out."""
        raise NotImplementedError

    def cleanup(self) -> None:
        pass
