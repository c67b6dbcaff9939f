"""Inputs made from the seed: the on-disk trial tree that the fit cells
train from, and the trials and clips that the serving cells send.

Every array is drawn on the run's device from a generator of its own
stream, in a few large calls, and copied to the host. Responses are
Gamma(1.5, 1), drawn as half the sum of three squared normals.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch


def sub_seed(seed: int, stream: str) -> int:
    """A 63-bit seed of its own for each named stream of one run's seed."""
    words = np.random.SeedSequence([seed, *stream.encode()]).generate_state(2, np.uint32)
    return int(words[0]) << 31 | int(words[1]) >> 1


class Draws:
    """Uniform and Gamma(1.5, 1) float32 arrays from one stream of the seed."""

    def __init__(self, seed: int, stream: str, device):
        self.device = device
        self.generator = torch.Generator(device=device).manual_seed(sub_seed(seed, stream))

    def uniform(self, low: float, high: float, shape) -> np.ndarray:
        u = torch.rand(shape, generator=self.generator, device=self.device)
        return (u * (high - low) + low).cpu().numpy()

    def gamma15(self, shape) -> np.ndarray:
        z = torch.randn((3, *shape), generator=self.generator, device=self.device)
        return (0.5 * z.square().sum(dim=0)).cpu().numpy()


def trial_arrays(draws: Draws, video_shape, length: int):
    """(video (h, w, T), behavior (2, T), pupil centre (2, T)) as the dataset stores them."""
    return (draws.uniform(0, 255, (*video_shape, length)), draws.uniform(0, 5, (2, length)),
            draws.uniform(50, 200, (2, length)))


def write_tree(root: Path, mice: list[str], neurons: list[int], trials: int, length: int, video_shape,
               seed: int, device) -> list[list[dict]]:
    """The dataset's layout (``<mouse>/data/{videos,behavior,pupil_center,
    responses}/<trial>.npy``, ``<mouse>/meta/...``), every trial a train
    trial; returns each mouse's trials as the reference reads them."""
    draws = Draws(seed, "tree", device)
    out = []
    for mouse, n in zip(mice, neurons):
        mdir = root / mouse
        for sub in ("data/videos", "data/behavior", "data/pupil_center", "data/responses", "meta/trials",
                    "meta/neurons"):
            (mdir / sub).mkdir(parents=True, exist_ok=True)
        np.save(mdir / "meta/trials/tiers.npy", np.array(["train"] * trials))
        np.save(mdir / "meta/neurons/unit_ids.npy", np.arange(1, n + 1, dtype=np.int64))
        np.save(mdir / "meta/neurons/cell_motor_coordinates.npy", draws.uniform(0, 100, (n, 3)))
        mouse_trials = []
        for trial in range(trials):
            video, behavior, pupil = trial_arrays(draws, video_shape, length)
            paths = {key: str(mdir / "data" / key / f"{trial}.npy")
                     for key in ("videos", "behavior", "pupil_center", "responses")}
            np.save(paths["videos"], video)
            np.save(paths["behavior"], behavior)
            np.save(paths["pupil_center"], pupil)
            np.save(paths["responses"], draws.gamma15((n, length)))
            mouse_trials.append({"video": paths["videos"], "behavior": paths["behavior"],
                                 "pupil_center": paths["pupil_center"], "responses": paths["responses"],
                                 "length": length})
        out.append(mouse_trials)
    return out
