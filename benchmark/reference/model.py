"""A plain float32 DwiseNeuro, the model of the Sensorium 2023 winning solution.

Written from the published architecture (github.com/lRomul/sensorium,
``src/models/dwiseneuro.py``) for the benchmark's correctness check. It
imports torch and numpy only, and nothing of the program it judges. Every
width comes from the configuration's ``nn_module`` dict; parameters live in
a flat ``{name: tensor}`` dict whose names and shapes are those of the
program's state dict, so that one set of weights made by the benchmark can
be handed to both.

Layout is channels-last, (B, T, H, W, C):

  stem: 1x1x1 conv in -> f0, BN
  9x  [+ 3-axis sinusoidal position table,
       inverted residual: 1x1x1 expand, BN, SiLU -> depthwise (1,k,k) with
       stride, BN, SiLU -> depthwise (k,1,1), BN, SiLU -> squeeze-excite ->
       1x1x1 project, BN; drop-path on the branch; shortcut: nearest
       downsample, channel tile, BN]
  mean over (H, W)
  3x  grouped 1x1 conv, BN, SiLU, channel shuffle, drop-path, + BN(shortcut)
  per-mouse readout: channel dropout, grouped 1x1 conv, softplus(beta)

Departures from the published code, each the program's as well: the
readout's grouped conv keeps ``ceil(N / G)`` rows a group and is cut to N;
the per-group rows are padded in the weight tensor (the padding is never
read); batch-norm statistics are kept as ``mean`` / ``var``.

``Precision`` says where values are rounded. ``float32`` rounds nowhere (the
reference). ``fp8`` rounds every stored activation, weight use and
gradient to float8 e4m3 with a scale of its own (the largest magnitude onto
448): the control, the step below the configuration's bfloat16.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

BN_EPS = 1e-5
BN_MOMENTUM = 0.1
FP8_MAX = 448.0


def _fp8(x: torch.Tensor) -> torch.Tensor:
    amax = x.detach().abs().amax().float()
    scale = torch.where(amax > 0, amax / FP8_MAX, torch.ones_like(amax))
    return ((x / scale).clamp(-FP8_MAX, FP8_MAX).to(torch.float8_e4m3fn).to(x.dtype) * scale).to(x.dtype)


class _RoundFp8(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        return _fp8(x)

    @staticmethod
    def backward(ctx, grad):
        return _fp8(grad)


@dataclass(frozen=True)
class Precision:
    name: str = "float32"

    def __post_init__(self):
        if self.name not in ("float32", "fp8"):
            raise ValueError(f"precision {self.name!r}: expected float32 or fp8")

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return x if self.name == "float32" else _RoundFp8.apply(x)


FLOAT32 = Precision("float32")


def set_exact_float32() -> None:
    """Float32 products stay float32 on the card: no TF32 anywhere."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# ------------------------------------------------------------------ sizes


def block_out_features(features, i: int) -> int:
    return features[i + 1] if i + 1 < len(features) else features[i]


def group_sizes(num_neurons: int, groups: int) -> list[int]:
    """Rows of each readout group that survive the cut to N: ceil(N/G) for
    the leading groups, the rest for the last."""
    per_group = math.ceil(num_neurons / groups)
    sizes, left = [], num_neurons
    for _ in range(groups):
        take = min(per_group, max(left, 0))
        sizes.append(take)
        left -= take
    return sizes


def padded_rows(cfg: dict) -> int:
    multiple = cfg.get("readout_pad_multiple", 128)
    largest = max(math.ceil(n / cfg["groups"]) for n in cfg["readout_outputs"])
    return -(-largest // multiple) * multiple


# ------------------------------------------------------------- parameters


def param_specs(cfg: dict) -> list[tuple[str, tuple, tuple, bool]]:
    """``(name, shape, init, is_parameter)`` of every tensor of the model.

    ``init`` is ``("normal", std)`` (kaiming-normal with the group-corrected
    fan-out, as the published model initializes its convs), ``("uniform",
    low, high)`` or ``("normal_mean", std)``. Batch-norm scales, biases and
    statistics are drawn near their defaults, so that eval mode does not
    reduce every BN to the identity.
    """
    specs = []

    def kernel(name, shape, fan_out):
        specs.append((name, tuple(shape), ("normal", math.sqrt(2.0 / fan_out)), True))

    def bn(prefix, c):
        specs.append((f"{prefix}.bn.scale", (c,), ("uniform", 0.9, 1.1), True))
        specs.append((f"{prefix}.bn.bias", (c,), ("normal", 0.05), True))
        specs.append((f"{prefix}.bn.mean", (c,), ("normal", 0.1), False))
        specs.append((f"{prefix}.bn.var", (c,), ("uniform", 0.8, 1.25), False))

    features = cfg["core_features"]
    k, kt = cfg["spatial_kernel"], cfg["temporal_kernel"]
    kernel("stem_kernel", (cfg["in_channels"], features[0]), features[0])
    bn("stem_bn", features[0])
    for i, cin in enumerate(features):
        mid = cin * cfg["expansion_ratio"]
        cout = block_out_features(features, i)
        rd = mid // cfg["se_reduce_ratio"]
        p = f"block_{i}"
        kernel(f"{p}.pw_kernel", (cin, mid), mid)
        bn(f"{p}.pw_bn", mid)
        kernel(f"{p}.spatial_dw_kernel", (k, k, mid), k * k)
        bn(f"{p}.spatial_bn", mid)
        kernel(f"{p}.temporal_dw_kernel", (kt, mid), kt)
        bn(f"{p}.temporal_bn", mid)
        kernel(f"{p}.se.reduce_kernel", (mid, rd), rd)
        specs.append((f"{p}.se.reduce_bias", (rd,), ("normal", 0.05), True))
        kernel(f"{p}.se.expand_kernel", (rd, mid), mid)
        specs.append((f"{p}.se.expand_bias", (mid,), ("normal", 0.05), True))
        kernel(f"{p}.pwl_kernel", (mid, cout), cout)
        bn(f"{p}.pwl_bn", cout)
        bn(f"{p}.bn_sc", cout)
    groups = cfg["groups"]
    prev = features[-1]
    for i, width in enumerate(cfg["cortex_features"]):
        kernel(f"cortex_{i}.kernel", (groups, prev // groups, width // groups), width // groups)
        bn(f"cortex_{i}.bn", width)
        bn(f"cortex_{i}.bn_sc", width)
        prev = width
    mice = len(cfg["readout_outputs"])
    pad = padded_rows(cfg)
    specs.append(("readout_kernel", (mice, groups, prev // groups, pad), ("readout",), True))
    specs.append(("readout_bias", (mice, groups, pad), ("normal", 0.05), True))
    return specs


def readout_stds(cfg: dict) -> list[float]:
    return [math.sqrt(2.0 / math.ceil(n / cfg["groups"])) for n in cfg["readout_outputs"]]


# ------------------------------------------------------------------- parts


@dataclass
class Masks:
    """A training forward's stochastic masks, drawn before it runs: the
    (B,1,1,1,1) drop-path mask of each core block with a rate above 0, the
    (B,1,1) mask of each cortex layer and the (M,B,1,C) channel-dropout mask
    of the readouts. Values are 0 or 1/keep."""

    blocks: dict = field(default_factory=dict)
    cortex: list = field(default_factory=list)
    readout: torch.Tensor | None = None


def draw_masks(cfg: dict, batch: int, generator: torch.Generator, device) -> Masks:
    """The masks in the order the model draws them: one uniform draw a mask
    from ``generator``, kept where the draw is below the keep rate."""
    masks = Masks()
    rate, drop = cfg["drop_path_rate"], cfg["drop_rate"]
    blocks = len(cfg["core_features"])

    def keep_mask(shape, rate):
        keep = 1.0 - rate
        return (torch.rand(shape, generator=generator, device=device) < keep).float() / keep

    for i in range(blocks):
        r = rate * i / blocks
        if r > 0.0:
            masks.blocks[i] = keep_mask((batch, 1, 1, 1, 1), r)
    if rate > 0.0:
        masks.cortex = [keep_mask((batch, 1, 1), rate) for _ in cfg["cortex_features"]]
    if drop > 0.0:
        masks.readout = keep_mask((len(cfg["readout_outputs"]), batch, 1, cfg["cortex_features"][-1]), drop)
    return masks


_PE_TABLES: dict = {}


def position_table(channels: int, t: int, h: int, w: int) -> np.ndarray:
    """(T, H, W, C) sinusoidal table: ceil(C/6)*2 channels an axis (made
    even), sines then cosines of each axis's positions at frequencies
    10000^(-2i/ch), the three axes concatenated and cut to C."""
    key = (channels, t, h, w)
    if key not in _PE_TABLES:
        per_axis = math.ceil(channels / 6) * 2
        per_axis += per_axis % 2
        inv_freq = 1.0 / (10000 ** (np.arange(0, per_axis, 2, dtype=np.float32) / per_axis))

        def axis(length):
            angles = np.outer(inv_freq, np.arange(length, dtype=np.float32))
            return np.concatenate([np.sin(angles), np.cos(angles)], axis=0)

        table = np.zeros((3 * per_axis, t, h, w), dtype=np.float32)
        table[:per_axis] = axis(t)[:, :, None, None]
        table[per_axis:2 * per_axis] = axis(h)[:, None, :, None]
        table[2 * per_axis:] = axis(w)[:, None, None, :]
        _PE_TABLES[key] = np.ascontiguousarray(np.transpose(table[:channels], (1, 2, 3, 0)))
    return _PE_TABLES[key]


def batch_norm(x, params, prefix, train: bool, stats: dict | None, q: Precision):
    """BN over the channel axis: batch statistics (biased variance) in
    training, recorded in ``stats`` for the running update; the running
    statistics in eval."""
    scale, bias = params[f"{prefix}.bn.scale"], params[f"{prefix}.bn.bias"]
    flat = x.reshape(-1, x.shape[-1])
    if train:
        with torch.no_grad():
            var, mean = torch.var_mean(flat, dim=0, unbiased=False)
        stats[prefix] = (mean, var, flat.shape[0])
        y = F.batch_norm(flat, None, None, scale, bias, training=True, eps=BN_EPS)
    else:
        y = F.batch_norm(flat, params[f"{prefix}.bn.mean"], params[f"{prefix}.bn.var"], scale, bias,
                         training=False, eps=BN_EPS)
    return q(y.reshape(x.shape))


def bn_act(x, params, prefix, train, stats, q, act=True):
    y = batch_norm(x, params, prefix, train, stats, q)
    return q(F.silu(y)) if act else y


def dw_spatial(x: torch.Tensor, w: torch.Tensor, stride: int) -> torch.Tensor:
    """Depthwise (1,k,k) conv, zero padding k//2: x (B,T,H,W,C), w (k,k,C)."""
    b, t, h, wd, c = x.shape
    k = w.shape[0]
    y = F.conv2d(x.reshape(b * t, h, wd, c).permute(0, 3, 1, 2), w.permute(2, 0, 1)[:, None],
                 stride=stride, padding=k // 2, groups=c)
    return y.permute(0, 2, 3, 1).reshape(b, t, y.shape[2], y.shape[3], c)


def dw_temporal(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise (k,1,1) conv over T, zero padding k//2: w (k, C)."""
    k, t = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, 0, 0, 0, 0, k // 2, k // 2))
    y = xp[:, 0:t] * w[0]
    for j in range(1, k):
        y = y + xp[:, j:j + t] * w[j]
    return y


def tile(x: torch.Tensor, features: int) -> torch.Tensor:
    reps = math.ceil(features / x.shape[-1])
    return torch.cat([x] * reps, dim=-1)[..., :features]


def block_forward(x, params, cfg, i, mask, train, stats, q):
    p = f"block_{i}"
    s = cfg["spatial_strides"][i]
    cout = block_out_features(cfg["core_features"], i)
    shortcut = x
    if s > 1:
        _, _, h, w, _ = x.shape
        if h % s == 0 and w % s == 0:
            shortcut = shortcut[:, :, ::s, ::s]
        else:
            oh, ow = math.ceil(h / s), math.ceil(w / s)
            rows = torch.arange(oh, device=x.device) * h // oh
            cols = torch.arange(ow, device=x.device) * w // ow
            shortcut = shortcut.index_select(2, rows).index_select(3, cols)
    if shortcut.shape[-1] != cout:
        shortcut = tile(shortcut, cout)
    shortcut = bn_act(shortcut, params, f"{p}.bn_sc", train, stats, q, act=False)
    y = bn_act(q(x @ q(params[f"{p}.pw_kernel"])), params, f"{p}.pw_bn", train, stats, q)
    y = bn_act(q(dw_spatial(y, q(params[f"{p}.spatial_dw_kernel"]), s)), params, f"{p}.spatial_bn", train, stats, q)
    y = bn_act(q(dw_temporal(y, q(params[f"{p}.temporal_dw_kernel"]))), params, f"{p}.temporal_bn", train, stats, q)
    squeezed = q(y.mean(dim=(1, 2, 3)))
    gate = q(F.silu(q(squeezed @ q(params[f"{p}.se.reduce_kernel"])) + q(params[f"{p}.se.reduce_bias"])))
    gate = q(torch.sigmoid(q(gate @ q(params[f"{p}.se.expand_kernel"])) + q(params[f"{p}.se.expand_bias"])))
    y = q(y * gate[:, None, None, None, :])
    y = bn_act(q(y @ q(params[f"{p}.pwl_kernel"])), params, f"{p}.pwl_bn", train, stats, q, act=False)
    if mask is not None:
        y = q(y * mask)
    return q(y + shortcut)


def shuffle(x: torch.Tensor, groups: int) -> torch.Tensor:
    *lead, c = x.shape
    return x.reshape(*lead, groups, c // groups).transpose(-1, -2).reshape(*lead, c)


def cortex_forward(x, params, cfg, i, mask, train, stats, q):
    p = f"cortex_{i}"
    kernel = q(params[f"{p}.kernel"])
    groups, cin_g, cout_g = kernel.shape
    y = torch.einsum("...gc,gcd->...gd", x.reshape(*x.shape[:-1], groups, cin_g), kernel)
    y = q(y.reshape(*x.shape[:-1], groups * cout_g))
    y = shuffle(bn_act(y, params, f"{p}.bn", train, stats, q), groups)
    if mask is not None:
        y = q(y * mask)
    width = groups * cout_g
    shortcut = x if x.shape[-1] == width else tile(x, width)
    return q(y + bn_act(shortcut, params, f"{p}.bn_sc", train, stats, q, act=False))


def readout(x, params, cfg, mouse: int, q) -> torch.Tensor:
    """(B, T, C) -> (B, N_mouse, T): grouped 1x1 conv, the rows of each group
    cut to N, softplus(beta)."""
    groups = cfg["groups"]
    xg = x.reshape(*x.shape[:-1], groups, x.shape[-1] // groups)
    logits = torch.einsum("btgc,gcp->btgp", xg, q(params["readout_kernel"][mouse])) + params["readout_bias"][mouse]
    out = F.softplus(logits, beta=cfg["softplus_beta"], threshold=20.0)
    sizes = group_sizes(cfg["readout_outputs"][mouse], groups)
    return torch.cat([out[:, :, g, :sizes[g]] for g in range(groups)], dim=-1).transpose(1, 2)


def forward(params: dict, inputs: torch.Tensor, cfg: dict, mouse: int | None = None, train: bool = False,
            masks: Masks | None = None, stats: dict | None = None, q: Precision = FLOAT32,
            checkpoint_blocks: bool = False) -> torch.Tensor:
    """inputs (B, 5, T, H, W) -> (B, N_mouse, T) for one mouse, or the
    (M, B, N_max, T) zero-padded predictions of every mouse. In training,
    ``masks`` holds the drawn masks and ``stats`` receives each BN's batch
    statistics. ``checkpoint_blocks`` recomputes each core block in the
    backward (memory only: the arithmetic is the same)."""
    if train and (masks is None or stats is None):
        raise ValueError("a training forward needs masks and a stats dict")
    masks = masks or Masks()
    x = q(inputs.permute(0, 2, 3, 4, 1).float())
    x = bn_act(q(x @ q(params["stem_kernel"])), params, "stem_bn", train, stats, q, act=False)
    for i in range(len(cfg["core_features"])):
        table = torch.from_numpy(position_table(x.shape[-1], *x.shape[1:4])).to(x.device)
        x = q(x + q(table))
        mask = masks.blocks.get(i) if train else None
        if checkpoint_blocks and torch.is_grad_enabled():
            x = checkpoint(block_forward, x, params, cfg, i, mask, train, stats, q, use_reentrant=False)
        else:
            x = block_forward(x, params, cfg, i, mask, train, stats, q)
    x = q(x.mean(dim=(2, 3)))
    for i in range(len(cfg["cortex_features"])):
        x = cortex_forward(x, params, cfg, i, masks.cortex[i] if train and masks.cortex else None, train, stats, q)
    keep_readout = train and masks.readout is not None
    if mouse is not None:
        if keep_readout:
            raise ValueError("the training forward runs every readout")
        return readout(x, params, cfg, mouse, q)
    outputs = []
    n_max = max(cfg["readout_outputs"])
    for m in range(len(cfg["readout_outputs"])):
        xm = q(x * masks.readout[m]) if keep_readout else x
        out = readout(xm, params, cfg, m, q)
        outputs.append(F.pad(out, (0, 0, 0, n_max - out.shape[1])))
    return torch.stack(outputs)


def update_running_stats(params: dict, stats: dict) -> None:
    """Each BN's running statistics after a training forward: momentum 0.1,
    the variance unbiased by n/(n-1)."""
    with torch.no_grad():
        for prefix, (mean, var, n) in stats.items():
            rm, rv = params[f"{prefix}.bn.mean"], params[f"{prefix}.bn.var"]
            rm.mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * mean)
            rv.mul_(1 - BN_MOMENTUM).add_(BN_MOMENTUM * var * (n / max(n - 1, 1)))
