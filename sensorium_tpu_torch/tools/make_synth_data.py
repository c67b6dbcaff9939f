"""Write a production-shaped synthetic dataset for the card's smokes.

Port of ``tools/make_synth_data.py``, with the same arguments and the same
draws in the same order, so the tree is byte for byte the JAX tool's. It
writes the Sensorium layout (``<root>/sensorium_all_2023/<mouse>/{data,
meta}/...``) for all 10 mice with their real neuron counts and the real
36x64 video geometry, but short trials: enough to drive the training and
predict CLIs at flagship model shapes without the 148 GB download. Pair it
with ``sensorium_tpu_torch/configs/smoke_001.py`` and
``SENSORIUM_FOLD_ASSIGNMENT=trial``.

    python -m sensorium_tpu_torch.tools.make_synth_data ROOT [--trial-length 120] [--trials 9] [--seed 0]

Then ``SENSORIUM_DATA_DIR=ROOT``. Per mouse: ``--trials`` labeled
("train") trials, then two unlabeled ones, which for the five new mice are
``live_test_main`` and ``final_test_main`` and for the old ones tier
``none`` (no files).
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

from sensorium_tpu_torch import constants


def write_tree(root: Path, trial_length: int = 120, trials: int = 9, seed: int = 0) -> Path:
    """Write the dataset under ``root / "sensorium_all_2023"``; returns that directory."""
    rng = np.random.default_rng(seed)
    length = trial_length
    root = Path(root) / "sensorium_all_2023"
    for mouse in constants.mice:
        num_neurons = constants.mouse2num_neurons[mouse]
        mouse_dir = root / mouse
        for sub in ("data/videos", "data/behavior", "data/pupil_center",
                    "data/responses", "meta/trials", "meta/neurons",
                    "meta/statistics/responses/all"):
            (mouse_dir / sub).mkdir(parents=True, exist_ok=True)

        new_mouse = mouse in constants.new_mice
        tiers = ["train"] * trials + (
            ["live_test_main", "final_test_main"] if new_mouse else ["none", "none"]
        )
        np.save(mouse_dir / "meta/trials/tiers.npy", np.array(tiers))
        np.save(mouse_dir / "meta/neurons/unit_ids.npy",
                np.arange(1, num_neurons + 1, dtype=np.int64))
        np.save(mouse_dir / "meta/neurons/cell_motor_coordinates.npy",
                rng.uniform(0, 100, (num_neurons, 3)).astype(np.float32))
        np.save(mouse_dir / "meta/statistics/responses/all/std.npy",
                rng.uniform(0.5, 2.0, (num_neurons,)).astype(np.float32))

        for trial_id, tier in enumerate(tiers):
            if tier == "none":
                continue
            np.save(mouse_dir / f"data/videos/{trial_id}.npy",
                    rng.uniform(0, 255, (36, 64, length)).astype(np.float32))
            np.save(mouse_dir / f"data/behavior/{trial_id}.npy",
                    rng.uniform(0, 5, (2, length)).astype(np.float32))
            np.save(mouse_dir / f"data/pupil_center/{trial_id}.npy",
                    rng.uniform(50, 200, (2, length)).astype(np.float32))
            if tier == "train":
                np.save(mouse_dir / f"data/responses/{trial_id}.npy",
                        rng.gamma(1.5, 1.0, (num_neurons, length)).astype(np.float32))
    return root


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("root", type=Path, help="SENSORIUM_DATA_DIR to create")
    parser.add_argument("--trial-length", type=int, default=120)
    parser.add_argument("--trials", type=int, default=9,
                        help="labeled trials per mouse (>=7 so every fold "
                             "is populated under trial-index assignment)")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)
    root = write_tree(args.root, args.trial_length, args.trials, args.seed)
    print(f"Synthetic dataset written to {root}")


if __name__ == "__main__":
    main()
