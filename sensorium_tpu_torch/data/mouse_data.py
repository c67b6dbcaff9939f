"""Trial catalogs of each mouse (counterpart of ``sensorium_tpu/data/mouse_data.py``).

From the on-disk dataset layout (``<sensorium_dir>/<mouse>/{data,meta}/...``)
this builds the list of a mouse's trials in a set of splits, with each
trial's file paths and NaN-trimmed length. Labeled trials are put into folds
by a perceptual hash of their video, so duplicate stimulus videos share a fold
(group k-fold).

``constants.sensorium_dir`` is read at every call. The fold tiers and the
video hashes are cached per process, keyed by the dataset root and the
assignment mode as well as the mouse.
"""

from __future__ import annotations

import functools
import os

import numpy as np

from sensorium_tpu_torch import constants
from sensorium_tpu_torch.data.phash import video_phash
from sensorium_tpu_torch.utils.misc import get_length_without_nan


def mouse_dir(mouse: str):
    return constants.sensorium_dir / mouse


def compute_video_phashes(mouse: str) -> np.ndarray:
    """Per-trial uint64 pHash (0 for trials of tier 'none'), read-only and cached."""
    return _video_phashes_cached(mouse, str(constants.sensorium_dir))


@functools.lru_cache(maxsize=None)
def _video_phashes_cached(mouse: str, root: str) -> np.ndarray:
    tiers = np.load(str(mouse_dir(mouse) / "meta" / "trials" / "tiers.npy"))
    phashes = np.zeros(tiers.shape[0], dtype=np.uint64)
    for trial_id, tier in enumerate(tiers):
        if tier == "none":
            continue
        video = np.load(str(mouse_dir(mouse) / "data" / "videos" / f"{trial_id}.npy"), mmap_mode="r")
        phashes[trial_id] = video_phash(np.asarray(video))
    phashes.flags.writeable = False
    return phashes


def get_folds_tiers(mouse: str, num_folds: int) -> np.ndarray:
    """The tier array with labeled trials re-assigned to 'fold_{phash % num_folds}'.

    For "new" mice only the train and oracle tiers carry responses, so only
    those are folded; for "old" mice every tier but 'none' is.
    ``SENSORIUM_FOLD_ASSIGNMENT=trial`` keys the folds by trial index
    instead of the video hash (balanced folds on synthetic data, and no
    Pillow needed). The result is read-only and cached.
    """
    return _folds_tiers_cached(
        mouse, num_folds, os.environ.get("SENSORIUM_FOLD_ASSIGNMENT", "phash"), str(constants.sensorium_dir)
    )


@functools.lru_cache(maxsize=None)
def _folds_tiers_cached(mouse: str, num_folds: int, assignment: str, root: str) -> np.ndarray:
    # Widen the string dtype: "fold_{k}" in a narrow (<U5) array would be cut.
    tiers = np.load(str(mouse_dir(mouse) / "meta" / "trials" / "tiers.npy")).astype("U32")
    if assignment == "trial":
        phashes = np.arange(tiers.shape[0], dtype=np.uint64)
    else:
        phashes = compute_video_phashes(mouse)
    if mouse in constants.new_mice:
        labeled = (tiers == "train") | (tiers == "oracle")
    else:
        labeled = tiers != "none"
    for trial_id in np.argwhere(labeled).ravel():
        tiers[trial_id] = f"fold_{int(phashes[trial_id]) % num_folds}"
    tiers.flags.writeable = False
    return tiers


def _clear_fold_caches() -> None:
    _folds_tiers_cached.cache_clear()
    _video_phashes_cached.cache_clear()


get_folds_tiers.cache_clear = _clear_fold_caches


def get_mouse_data(mouse: str, splits: list[str]) -> dict:
    """Catalog of ``mouse``'s trials in ``splits``: neuron metadata and a
    ``trials`` list, each with its id, usable length and the paths of its
    video, behavior, pupil-center (and, in a labeled split, responses) arrays."""
    if mouse not in constants.mice:
        raise ValueError(f"unknown mouse {mouse!r}; expected one of constants.mice")
    tiers = get_folds_tiers(mouse, constants.num_folds)
    mdir = mouse_dir(mouse)
    neuron_ids = np.load(str(mdir / "meta" / "neurons" / "unit_ids.npy"))
    catalog = {
        "mouse": mouse,
        "splits": splits,
        "neuron_ids": neuron_ids,
        "num_neurons": int(neuron_ids.shape[0]),
        "cell_motor_coordinates": np.load(str(mdir / "meta" / "neurons" / "cell_motor_coordinates.npy")),
        "trials": [],
    }
    for split in splits:
        if split in constants.folds_splits:
            labeled = True
        elif split in constants.unlabeled_splits:
            labeled = False
        else:
            raise ValueError(f"Unknown data split '{split}'")
        for trial_id in np.argwhere(tiers == split).ravel().tolist():
            behavior_path = str(mdir / "data" / "behavior" / f"{trial_id}.npy")
            trial = {
                "trial_id": trial_id,
                "video_path": str(mdir / "data" / "videos" / f"{trial_id}.npy"),
                "behavior_path": behavior_path,
                "pupil_center_path": str(mdir / "data" / "pupil_center" / f"{trial_id}.npy"),
                "length": get_length_without_nan(np.asarray(np.load(behavior_path, mmap_mode="r")[0])),
            }
            if labeled:
                response_path = str(mdir / "data" / "responses" / f"{trial_id}.npy")
                trial["response_path"] = response_path
                trial["length"] = get_length_without_nan(np.asarray(np.load(response_path, mmap_mode="r")[0]))
            catalog["trials"].append(trial)
    return catalog
