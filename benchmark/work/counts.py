"""The work a configuration asks for, counted from its shapes.

These counts are the numerators of the per-layer utilization metrics. They
count what the model's mathematics needs, whatever implements it, so that a
change that fuses, removes or reruns a kernel cannot move them:

* FLOPs: two for every multiply-add of a product (pointwise, grouped and
  readout convs, squeeze-excite) and of a depthwise tap. Elementwise work
  (BN, activations, the position table, means) is not counted. A training
  step is three forwards' worth (forward, and the backward's two products a
  forward product); a rematerialized block's rerun is not counted.
* Depthwise bytes: each input read once and each output written once per
  call, in the configuration's compute dtype, weight gradients in float32;
  operations: two per tap of each output (of each upstream gradient for the
  backward kernels). A call's least time is the larger of bytes over the
  card's memory rate and operations over its float32 rate (the kernels
  compute in float32).

``peaks.json`` beside this file holds the cards' published rates.
"""

from __future__ import annotations

import json
from pathlib import Path

PEAKS = json.loads((Path(__file__).with_name("peaks.json")).read_text())

_DTYPE_BYTES = {"bfloat16": 2, "float16": 2, "float32": 4}


def peaks_for(device_name: str) -> dict | None:
    """The published rates of the card whose name contains a key of the table, or None."""
    for key, rates in PEAKS["cards"].items():
        if key in device_name:
            return rates
    return None


def _blocks(cfg: dict, height: int, width: int):
    """(in features, mid, out features, stride, H_in, W_in, H_out, W_out) of each core block."""
    features = cfg["core_features"]
    k = cfg["spatial_kernel"]
    for i, cin in enumerate(features):
        s = cfg["spatial_strides"][i]
        cout = features[i + 1] if i + 1 < len(features) else features[i]
        oh, ow = (height + 2 * (k // 2) - k) // s + 1, (width + 2 * (k // 2) - k) // s + 1
        yield cin, cin * cfg["expansion_ratio"], cout, s, height, width, oh, ow
        height, width = oh, ow


def forward_flops(cfg: dict, batch: int, frames: int, height: int, width: int, mouse: int | None = None) -> float:
    """FLOPs of one forward of ``batch`` clips of ``frames`` x ``height`` x
    ``width``: one mouse's readout, or every mouse's (``mouse`` None)."""
    k, kt = cfg["spatial_kernel"], cfg["temporal_kernel"]
    bt = batch * frames
    flops = 2 * cfg["in_channels"] * cfg["core_features"][0] * bt * height * width
    for cin, mid, cout, _, h, w, oh, ow in _blocks(cfg, height, width):
        rd = mid // cfg["se_reduce_ratio"]
        flops += 2 * cin * mid * bt * h * w  # expand
        flops += 2 * k * k * mid * bt * oh * ow  # spatial taps
        flops += 2 * kt * mid * bt * oh * ow  # temporal taps
        flops += 2 * 2 * mid * rd * batch  # squeeze-excite
        flops += 2 * mid * cout * bt * oh * ow  # project
    groups = cfg["groups"]
    prev = cfg["core_features"][-1]
    for width_c in cfg["cortex_features"]:
        flops += 2 * (prev // groups) * (width_c // groups) * groups * bt
        prev = width_c
    neurons = sum(cfg["readout_outputs"]) if mouse is None else cfg["readout_outputs"][mouse]
    flops += 2 * (prev // groups) * neurons * bt
    return float(flops)


def train_flops_per_clip(cfg: dict, frames: int, height: int, width: int, teacher: dict | None = None) -> float:
    """A training step's FLOPs a clip: three all-mice forwards, plus the
    frozen teacher's all-mice forward where there is one."""
    flops = 3 * forward_flops(cfg, 1, frames, height, width)
    if teacher is not None:
        flops += forward_flops(teacher, 1, frames, height, width)
    return flops


def mean_eval_flops_per_window(cfg: dict, frames: int, height: int, width: int) -> float:
    """One window's single-mouse forward, averaged over the mice (the
    readout is the only part that depends on the mouse)."""
    mice = len(cfg["readout_outputs"])
    return sum(forward_flops(cfg, 1, frames, height, width, m) for m in range(mice)) / mice


def dw_calls(cfg: dict, batch: int, frames: int, height: int, width: int, backward: bool) -> list[dict]:
    """Every depthwise call of one forward (and, with ``backward``, of its
    backward) at ``batch`` clips: ``{"kernel", "bytes", "ops"}`` each."""
    e = _DTYPE_BYTES[cfg.get("dtype", "float32")]
    k, kt = cfg["spatial_kernel"], cfg["temporal_kernel"]
    calls = []
    for _, mid, _, _, h, w, oh, ow in _blocks(cfg, height, width):
        x = batch * frames * h * w * mid
        y = batch * frames * oh * ow * mid
        calls.append({"kernel": "dw_spatial_fwd", "bytes": (x + y + k * k * mid) * e, "ops": 2 * k * k * y})
        calls.append({"kernel": "dw_temporal_fwd", "bytes": (2 * y + kt * mid) * e, "ops": 2 * kt * y})
        if backward:
            calls.append({"kernel": "dw_spatial_dx", "bytes": (y + k * k * mid + x) * e, "ops": 2 * k * k * y})
            calls.append({"kernel": "dw_spatial_dw", "bytes": (x + y) * e + k * k * mid * 4, "ops": 2 * k * k * y})
            calls.append({"kernel": "dw_temporal_dx", "bytes": (2 * y + kt * mid) * e, "ops": 2 * kt * y})
            calls.append({"kernel": "dw_temporal_dw", "bytes": 2 * y * e + kt * mid * 4, "ops": 2 * kt * y})
    return calls


def least_seconds(calls: list[dict], rates: dict) -> float:
    """The summed least time of ``calls`` on a card of ``rates``."""
    return sum(max(c["bytes"] / rates["memory_bytes_per_s"], c["ops"] / rates["float32_flops"]) for c in calls)


def windows(length: int, frame_stack: dict) -> int:
    """The windows of a trial of ``length`` frames: one at every anchor
    from the first full window on."""
    return max(0, length - (frame_stack["size"] - 1) * frame_stack["step"])


def chunk_sizes(length: int, frame_stack: dict, chunk: int) -> list[int]:
    """The windows of each chunk forward of a trial of ``length`` frames."""
    total = windows(length, frame_stack)
    return [min(chunk, total - start) for start in range(0, total, chunk)]
