"""The readings that the limits of ``cells/<cell>.json`` are set from, taken
on the card at the cell's own size (the benchmark's own runs never run this):

* the program's gaps on each seed (the lower reading is the largest);
* on the first ``--control-seeds`` seeds, the control: the reference in
  float8 (e4m3, a scale a tensor) put in the program's place, the step below
  the configuration's bfloat16, against the float32 reference;
* on the same seeds, the driver's planted faults: for a training cell the
  reference with half of each batch left out (the mean taken over the rest)
  in the program's place.

A step that leaves the state unchanged reads 1 on the change and EMA gaps
by their definition, and needs no run.

    python3 -m benchmark.tools.calibrate --workload <cell> --seeds 11,12,... [--control-seeds 3] [--seconds 3]

One JSON line a seed on standard output.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch

from benchmark.harness import spec


def readings(cell: spec.Cell, seed: int, control: bool, seconds: float, devices) -> dict:
    """The program's numbers on ``seed`` after a window of ``seconds``, and
    with ``control`` those of the control and of the driver's faults."""
    driver = spec.driver_class(cell)(cell, seed, devices)
    out = {"seed": seed}
    try:
        driver.setup()
        driver.window(time.perf_counter() + seconds)
        driver.free()
        out["program"], out["program_details"] = driver.check()
        if control:
            out.update(driver.faults())
    finally:
        driver.cleanup()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control-seeds", type=int, default=3)
    parser.add_argument("--seconds", type=float, default=3.0)
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate reads on the card: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    stdout = sys.stdout
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        with contextlib.redirect_stdout(sys.stderr):
            devices = [torch.device("cuda", d) for d in range(cell.chips)]
            line = readings(cell, seed, i < args.control_seeds, args.seconds, devices)
        print(json.dumps(line), file=stdout, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
