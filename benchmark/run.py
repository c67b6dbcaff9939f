"""Run one cell of ``BENCHMARK.json`` once, as the check calls it:

    python3 -m benchmark.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result: ``correct``, ``attempted``, ``failed``, ``metrics`` (the cell's
end-to-end metrics, or with ``--trace 1`` its per-layer ones), ``device``
(and with ``--trace 1`` ``breakdown``), then ``compared``: each number that
decides ``correct`` beside its limit. Everything else goes to standard
error, ending with the compared numbers. Without a CUDA card, or with fewer
cards than the cell asks for, it prints no result and exits 2.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Python's bytecode is a build cache too: it goes to a fixed directory of the
# checkout, so that only a checkout's first run compiles the sources it
# imports (torch's among them: ~8 s a run on the card's machine otherwise).
sys.pycache_prefix = str(ROOT / "build" / "pycache")
sys.dont_write_bytecode = False

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="one run of one benchmark cell")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    import torch

    from benchmark.harness import runner, spec

    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"the cell needs {cell.chips} CUDA card(s); torch.cuda.is_available() is "
              f"{torch.cuda.is_available()}, {torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    stdout = sys.stdout
    with contextlib.redirect_stdout(sys.stderr):
        devices = [torch.device("cuda", i) for i in range(cell.chips)]
        result = runner.run(cell, args.seed, args.seconds, bool(args.trace), devices, STARTED)
    print(json.dumps(result), file=stdout, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
