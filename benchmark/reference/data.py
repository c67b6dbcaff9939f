"""Plain batch assembly and whole-trial prediction of the published recipe.

Training samples (the reference's ``MiceDataset`` with CutMix, keyed as the
recipe keys them): the loader's order is ``arange(E)`` shuffled by
``default_rng((seed, epoch))``; sample ``i`` belongs to mouse ``i // (E /
mice)`` and draws, from ``default_rng((seed, epoch, i))``, a trial, an
anchor frame, then (with probability ``prob``) a CutMix partner drawn the
same way from ``default_rng((seed, epoch, i, 1))``, a Beta(alpha, alpha)
area and a box centre. A window is ``size`` frames every ``step`` frames
ending at the anchor; its input stacks the video (centred on the canvas),
two behaviour and two pupil signals as planes; its target is the responses
at those frames, clamped at 0.

Whole trials: every anchor from the first full window to the last frame,
each window's prediction added to the frames it covers, divided by how
many windows cover each frame (blend weights all ones).

Imports numpy, torch and this folder only.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import model as ref


def window_frames(anchor: int, size: int, step: int) -> np.ndarray:
    return np.arange(anchor - (size - 1) * step, anchor + 1, step)


def stack_inputs(video, behavior, pupil, frames, canvas, fill: float = 0.0) -> np.ndarray:
    """(5, S, H, W): the video (h, w, T) centred on the (H, W) canvas, then
    the two behaviour and two pupil-centre signals as constant planes."""
    height, width = canvas
    out = np.full((5, len(frames), height, width), fill, np.float32)
    h, w = video.shape[:2]
    h0, w0 = (height - h) // 2, (width - w) // 2
    out[0, :, h0:h0 + h, w0:w0 + w] = np.transpose(np.asarray(video[:, :, frames], np.float32), (2, 0, 1))
    out[1:3] = np.asarray(behavior[:, frames], np.float32)[:, :, None, None]
    out[3:5] = np.asarray(pupil[:, frames], np.float32)[:, :, None, None]
    return out


class Tree:
    """A data tree's trials: ``mice[m]`` is a list of dicts with the paths of
    ``video`` (h, w, T), ``behavior`` (2, T), ``pupil_center`` (2, T) and
    ``responses`` (N, T), and ``length``."""

    def __init__(self, mice: list[list[dict]]):
        self.mice = mice
        self._arrays: dict = {}

    def array(self, path: str) -> np.ndarray:
        if path not in self._arrays:
            self._arrays[path] = np.load(path, mmap_mode="r")
        return self._arrays[path]


def _draw_window(tree: Tree, mouse: int, rng, size: int, step: int):
    trials = tree.mice[mouse]
    behind = (size - 1) * step
    valid = [t for t, trial in enumerate(trials) if trial["length"] >= behind + 1]
    trial = trials[valid[rng.integers(len(valid))]]
    return trial, int(rng.integers(behind, trial["length"]))


def _sample(tree: Tree, mouse: int, rng, frame_stack: dict, canvas, fill: float):
    trial, anchor = _draw_window(tree, mouse, rng, frame_stack["size"], frame_stack["step"])
    frames = window_frames(anchor, frame_stack["size"], frame_stack["step"])
    inputs = stack_inputs(tree.array(trial["video"]), tree.array(trial["behavior"]),
                          tree.array(trial["pupil_center"]), frames, canvas, fill)
    target = np.maximum(np.asarray(tree.array(trial["responses"])[:, frames], np.float32), 0.0)
    return inputs, target


def train_sample(tree: Tree, index: int, seed: int, epoch: int, mouse_epoch_size: int, frame_stack: dict,
                 canvas, cutmix: dict | None, fill: float = 0.0):
    """(mouse, inputs (5, S, H, W), target (N, S)) of sample ``index``."""
    mouse = index // mouse_epoch_size
    rng = np.random.default_rng((seed, epoch, index))
    inputs, target = _sample(tree, mouse, rng, frame_stack, canvas, fill)
    if cutmix is not None and rng.random() < cutmix["prob"]:
        partner = _sample(tree, mouse, np.random.default_rng((seed, epoch, index, 1)), frame_stack, canvas, fill)
        lam = rng.beta(cutmix["alpha"], cutmix["alpha"])
        h, w = inputs.shape[-2:]
        cut_h, cut_w = int(h * np.sqrt(lam)), int(w * np.sqrt(lam))
        cx, cy = rng.integers(w), rng.integers(h)
        # The published box: x against the width, y against the height, and
        # the input indexed [..., x1:x2, y1:y2].
        x1, x2 = int(np.clip(cx - cut_w // 2, 0, w)), int(np.clip(cx + cut_w // 2, 0, w))
        y1, y2 = int(np.clip(cy - cut_h // 2, 0, h)), int(np.clip(cy + cut_h // 2, 0, h))
        inputs[..., x1:x2, y1:y2] = partner[0][..., x1:x2, y1:y2]
        area = (x2 - x1) * (y2 - y1) / (h * w)
        target = target * (1 - area) + partner[1] * area
    return mouse, inputs, target


def train_batch(tree: Tree, batch_index: int, seed: int, epoch: int, batch_size: int, epoch_size: int,
                num_mice: int, max_neurons: int, frame_stack: dict, canvas, cutmix: dict | None, fill: float = 0.0):
    """Batch ``batch_index`` of epoch ``epoch``: (inputs (B,5,S,H,W),
    targets (B, N_max, S) zero-padded, weights (B, M) one-hot)."""
    order = np.arange(epoch_size)
    np.random.default_rng((seed, epoch)).shuffle(order)
    rows = order[batch_index * batch_size:(batch_index + 1) * batch_size]
    size = frame_stack["size"]
    inputs = np.empty((len(rows), 5, size, *canvas), np.float32)
    targets = np.zeros((len(rows), max_neurons, size), np.float32)
    weights = np.zeros((len(rows), num_mice), np.float32)
    for row, index in enumerate(rows):
        mouse, x, t = train_sample(tree, int(index), seed, epoch, epoch_size // num_mice, frame_stack, canvas,
                                   cutmix, fill)
        inputs[row], targets[row, :t.shape[0]], weights[row, mouse] = x, t, 1.0
    return inputs, targets, weights


@torch.no_grad()
def predict_trial(params: dict, cfg: dict, video, behavior, pupil, mouse: int, frame_stack: dict, canvas,
                  device, chunk: int = 32, q: ref.Precision = ref.FLOAT32) -> np.ndarray:
    """(N, T) float32: the blend of the eval forwards of every window of the trial."""
    length = video.shape[-1]
    size, step = frame_stack["size"], frame_stack["step"]
    anchors = np.arange((size - 1) * step, length)
    stack = torch.from_numpy(stack_inputs(video, behavior, pupil, np.arange(length), canvas)).to(device)
    acc = torch.zeros((cfg["readout_outputs"][mouse], length), dtype=torch.float32, device=device)
    count = torch.zeros(length, dtype=torch.float32, device=device)
    for start in range(0, len(anchors), chunk):
        frames = torch.from_numpy(np.stack([window_frames(a, size, step) for a in anchors[start:start + chunk]]))
        frames = frames.to(device)
        batch = stack[:, frames].permute(1, 0, 2, 3, 4)  # (C, 5, S, H, W)
        pred = ref.forward(params, batch, cfg, mouse=mouse, q=q)  # (C, N, S)
        for w in range(pred.shape[0]):
            acc[:, frames[w]] += pred[w]
            count[frames[w]] += 1.0
    return (acc / count.clamp(min=1.0)).cpu().numpy()
