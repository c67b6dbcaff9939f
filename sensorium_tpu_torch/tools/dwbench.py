"""Microbenchmark: depthwise-conv lowerings of a BN -> SiLU -> depthwise block.

Port of ``tools/dwbench.py``. Per shape it times:

* spatial, ``dwconv_{3x3, stride}(silu(x * scale + shift))``:
  - ``chain``: the prologue in eager PyTorch (fp32, cast back to x's dtype),
    then ``F.conv3d(groups=C)`` (cuDNN);
  - ``chain2d``: the same prologue, then ``F.conv2d(groups=C)`` over (B*T, C, H, W);
  - ``chainshift``: the same prologue, then shifted multiply-adds in eager
    PyTorch, accumulated in fp32;
  - ``pallas``: the same prologue, then the port's ``dw_spatial_fwd`` kernel
    (the JAX tool's name for its Pallas kernel);
  - ``fused``: the port's ``fused_bn_silu_dw_spatial`` kernel, prologue inside.
* temporal, ``dwconv_{k=5 over T}(silu(x * scale + shift))``: ``chain``
  (``F.conv3d``) and ``pallas`` (the port's ``dw_temporal_fwd``).

The shape lists are the JAX tool's, kept for parity. They are not all the
flagship model's: the model expands ``in_features * 7`` channels
(``configs/true_batch_001.py``), so its block 4 runs 896 channels at 32x32
stride 2 and its block 7 1792 at 16x16 stride 2, where the lists below say
448 and 896 (``chip_smoke.flagship_kernel_shapes`` computes the model's).

    python -m sensorium_tpu_torch.tools.dwbench [--device cuda] [--iters 30]

Prints one JSON line per (shape, impl): ``{"shape", "impl", "device", "ms"}``,
or ``"error"`` in place of ``"ms"`` for an impl that raised. A ``fused`` line
also carries its largest difference from ``pallas`` and whether that is
within one bf16 rounding of the activation (``pallas`` rounds the
activation to x's dtype before the conv; ``fused`` does not). Times are
CUDA-event means over ``--iters`` calls after one warm-up on the card, host
clock on the CPU. Exits 1 if any impl failed or ``fused`` disagreed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch
import torch.nn.functional as F

from sensorium_tpu_torch.ops import dw_kernels

# (B, T, H, W, C, stride), as in tools/dwbench.py.
SHAPES = [
    ("block0", (32, 16, 64, 64, 448, 2)),
    ("block1-3", (32, 16, 32, 32, 448, 1)),
    ("block4", (32, 16, 32, 32, 448, 2)),
    ("block5-6", (32, 16, 16, 16, 896, 1)),
    ("block7", (32, 16, 16, 16, 896, 2)),
    ("block8", (32, 16, 8, 8, 1792, 1)),
]
K = 3
TEMPORAL_SHAPES = [
    ("t-block0-3", (32, 16, 32, 32, 448)),
    ("t-block4-6", (32, 16, 16, 16, 896)),
    ("t-block7-8", (32, 16, 8, 8, 1792)),
]
TEMPORAL_K = 5
ITERS = 30
BF16_RTOL = 2.0**-8
ATOL = 1e-5


def prologue(x, scale, shift):
    """``silu(x * scale + shift)`` in fp32, cast to x's dtype."""
    return F.silu(torch.addcmul(shift, x.float(), scale)).to(x.dtype)


def chain(x, scale, shift, taps, stride):
    k, c = taps.shape[0], taps.shape[-1]
    y = prologue(x, scale, shift).permute(0, 4, 1, 2, 3)
    out = F.conv3d(y, taps.permute(2, 0, 1)[:, None, None], stride=(1, stride, stride),
                   padding=(0, k // 2, k // 2), groups=c)
    return out.permute(0, 2, 3, 4, 1)


def chain2d(x, scale, shift, taps, stride):
    b, t, h, w, c = x.shape
    k = taps.shape[0]
    y = prologue(x, scale, shift).reshape(b * t, h, w, c).permute(0, 3, 1, 2)
    out = F.conv2d(y, taps.permute(2, 0, 1)[:, None], stride=stride, padding=k // 2, groups=c)
    return out.permute(0, 2, 3, 1).reshape(b, t, *out.shape[2:], c)


def chainshift(x, scale, shift, taps, stride):
    return dw_kernels.dw_spatial_plain(prologue(x, scale, shift), taps, stride)


def pallas(x, scale, shift, taps, stride):
    return dw_kernels.dw_spatial_fwd(prologue(x, scale, shift), taps, stride)


def fused(x, scale, shift, taps, stride):
    return dw_kernels.fused_bn_silu_dw_spatial(x, scale, shift, taps, stride)


def chain_t(x, scale, shift, taps):
    k, c = taps.shape
    y = prologue(x, scale, shift).permute(0, 4, 1, 2, 3)
    out = F.conv3d(y, taps.t()[:, None, :, None, None], padding=(k // 2, 0, 0), groups=c)
    return out.permute(0, 2, 3, 4, 1)


def pallas_t(x, scale, shift, taps):
    return dw_kernels.dw_temporal_fwd(prologue(x, scale, shift), taps)


SPATIAL_IMPLS = {"chain": chain, "chain2d": chain2d, "chainshift": chainshift, "pallas": pallas, "fused": fused}
TEMPORAL_IMPLS = {"chain": chain_t, "pallas": pallas_t}


def make_inputs(gen: torch.Generator, shape, taps_shape, dtype, device):
    """x ~ N(0, 1), scale ~ N(1, 0.2), shift ~ N(0, 0.2) (fp32), taps ~ N(0, 0.5), as the JAX tool draws them."""

    def normal(size, mean, std):
        return torch.randn(size, generator=gen, device=device) * std + mean

    x = normal(shape, 0.0, 1.0).to(dtype)
    c = shape[-1]
    return x, normal((c,), 1.0, 0.2), normal((c,), 0.0, 0.2), normal(taps_shape, 0.0, 0.5).to(dtype)


def timed(fn, device: torch.device, iters: int) -> float:
    """Mean milliseconds per call after one warm-up call."""
    fn()
    if device.type == "cuda":
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize(device)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters
    start = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - start) / iters * 1e3


def fused_against_pallas(inputs, stride: int) -> dict:
    """The largest |fused - pallas| and whether every element is within one
    rounding of the activation, carried through the taps, plus one rounding
    of each output: 2**-8 * (sum |w| |a| + |pallas| + |fused|) + 1e-5
    (2**-8 is bf16's unit roundoff)."""
    x, scale, shift, taps = inputs
    got, ref = fused(*inputs, stride).float(), pallas(*inputs, stride).float()
    act = F.silu(torch.addcmul(shift, x.float(), scale)).abs()
    magnitude = dw_kernels.dw_spatial_plain(act, taps.float().abs(), stride)
    diff = (got - ref).abs()
    within = bool(torch.all(diff <= BF16_RTOL * (magnitude + ref.abs() + got.abs()) + ATOL))
    return {"max_abs_diff_vs_pallas": float(diff.max()), "within_one_rounding_of_pallas": within}


def run(device, iters: int = ITERS, seed: int = 0, dtype=torch.bfloat16, emit=print) -> list[dict]:
    """Every impl at every shape of ``TEMPORAL_SHAPES`` then ``SHAPES``;
    ``emit`` gets each record's JSON line as it is made."""
    device = torch.device(device)
    gen = torch.Generator(device=device).manual_seed(seed)
    records = []

    def bench(name, impls, inputs, **kwargs):
        for impl, fn in impls.items():
            record = {"shape": name, "impl": impl, "device": device.type}
            try:
                record["ms"] = timed(lambda: fn(*inputs, **kwargs), device, iters)  # noqa: B023
                if impl == "fused":
                    record.update(fused_against_pallas(inputs, kwargs["stride"]))
            except Exception as exc:  # noqa: BLE001 -- reported, and the run fails
                record["error"] = f"{type(exc).__name__}: {exc}"[:160]
            records.append(record)
            emit(json.dumps(record))

    for name, (b, t, h, w, c) in TEMPORAL_SHAPES:
        bench(name, TEMPORAL_IMPLS, make_inputs(gen, (b, t, h, w, c), (TEMPORAL_K, c), dtype, device))
    for name, (b, t, h, w, c, stride) in SHAPES:
        bench(name, SPATIAL_IMPLS, make_inputs(gen, (b, t, h, w, c), (K, K, c), dtype, device), stride=stride)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return records


def failed(records: list[dict]) -> list[dict]:
    return [r for r in records if "error" in r or r.get("within_one_rounding_of_pallas") is False]


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    parser.add_argument("--iters", type=int, default=ITERS, help="timed calls per (shape, impl)")
    args = parser.parse_args(argv)
    from sensorium_tpu_torch.utils.device import resolve_device

    records = run(resolve_device(args.device), iters=args.iters, emit=lambda line: print(line, flush=True))
    return 1 if failed(records) else 0


if __name__ == "__main__":
    sys.exit(main())
