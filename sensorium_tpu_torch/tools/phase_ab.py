"""Serving and the train step of several checkouts of the repo, in turns, on one card.

    python -m sensorium_tpu_torch.tools.phase_ab ROOT [ROOT ...]

For each ROOT in the order given (for an A/B: parent, change, change,
parent), a fresh process builds that checkout's kernels and runs its
``chip_smoke.py`` phase 4 (3 flagship requests through the ``Predictor``)
and phase 7 (2 + 10 flagship train steps), with their checks, and prints one
line ``AB {"root", "windows_per_second", "seconds_per_step", "smi"}``. A
checkout made with ``git archive`` into a directory that ``.gitignore``
lists (``build/``) is a ROOT like the repo's own.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

CHILD = """
import json, sys
from pathlib import Path
root = Path(sys.argv[1])
sys.path.insert(0, str(root))
import torch
import chip_smoke
from sensorium_tpu_torch.ops import _build
if Path(chip_smoke.__file__).resolve().parent != root:
    raise SystemExit(f"imported {chip_smoke.__file__}, not the chip_smoke.py of {root}")
torch.backends.cudnn.allow_tf32 = False
torch.backends.cuda.matmul.allow_tf32 = False
_build.build_all()
out = root / "build" / "phase_ab"
out.mkdir(parents=True, exist_ok=True)
record = {}
chip_smoke.serve(record, out)
chip_smoke.train(record, out)
print("AB " + json.dumps({"root": str(root), "windows_per_second": record["serve"]["windows_per_second"],
                          "seconds_per_step": record["train"]["seconds_per_step"],
                          "smi": chip_smoke.nvidia_smi_line()}), flush=True)
"""


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("roots", nargs="+", type=Path, help="checkouts of the repo, run in this order")
    args = parser.parse_args(argv)
    for root in args.roots:
        root = root.resolve()
        # The child imports the checkout's own package: run it from the checkout.
        proc = subprocess.run([sys.executable, "-c", CHILD, str(root)], cwd=root, capture_output=True, text=True)
        lines = [line for line in proc.stdout.splitlines() if line.startswith(("AB ", "slice:", "train:"))]
        print("\n".join(lines), flush=True)
        if proc.returncode != 0:
            print(proc.stderr[-4000:], file=sys.stderr)
            return proc.returncode
    return 0


if __name__ == "__main__":
    sys.exit(main())
