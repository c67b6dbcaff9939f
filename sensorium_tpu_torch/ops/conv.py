"""Convolution primitives of the DwiseNeuro core, channels-last.

Counterpart of ``sensorium_tpu/ops/conv.py``. Every 3-D conv of the core is
factorized into pointwise (1x1x1), spatial depthwise (1,k,k) and temporal
depthwise (k,1,1) pieces:

* pointwise and grouped 1x1 convs are matrix products over the channel axis,
  accumulated in fp32 and rounded once to the input dtype;
* the depthwise convs go to the autograd Functions of ``ops/dw_kernels.py``:
  hand-written CUDA kernels forward and backward (their plain versions for
  CPU tensors). ``SENSORIUM_DW_IMPL=cudnn`` sends them to PyTorch's grouped
  ``conv3d`` instead, forward and backward (``_dw_implementation``), which
  is how ``tools/bench.py --ab`` times a whole step both ways;
* in eval, a BN with its SiLU whose only reader is a depthwise conv runs
  inside that conv's kernel (``depthwise_conv_spatial_bn``,
  ``depthwise_conv_temporal_bn``), bitwise the chain of the two, where
  ``eval_bn_runs_in_dw`` says the kernels' route takes it.

All tensors are channels-last: 3-D data is (B, T, H, W, C), 1-D data is
(B, T, C).

On the card, a bf16 product accumulates in fp32 only when cuBLAS is not
allowed reduced-precision reductions; ``set_matmul_policy`` sets that (and
keeps fp32 products out of TF32), and the entry points call it.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from sensorium_tpu_torch.ops.dw_kernels import (
    COMPILED_KS,
    dw_spatial,
    dw_spatial_fwd_bn,
    dw_temporal,
    dw_temporal_fwd_bn,
)

DW_IMPLEMENTATIONS = ("cuda", "cudnn")


def set_matmul_policy() -> None:
    """bf16 products accumulate in fp32, fp32 products run in full fp32.

    The JAX package asks for fp32 accumulation of every bf16 dot
    (``preferred_element_type``) and computes the readout logits from fp32
    operands; these process-wide switches give the same on the card.
    """
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    torch.backends.cuda.matmul.allow_tf32 = False


def einsum_f32(spec: str, *operands: torch.Tensor) -> torch.Tensor:
    """Einsum with fp32 operands and result, for bf16 or fp32 inputs.

    bf16 embeds exactly in fp32, so upcasting the operands gives the fp32
    accumulation of bf16 products (the readout logits feed softplus at full
    precision).
    """
    dtype = torch.promote_types(torch.float32, operands[0].dtype)
    return torch.einsum(spec, *(o.to(dtype) for o in operands))


def pointwise(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """1x1 conv over the trailing channel axis: (..., Cin) @ (Cin, Cout).

    A product of two bf16 tensors accumulates in fp32 and rounds once to bf16.
    """
    return torch.matmul(x, kernel).to(x.dtype)


def grouped_pointwise(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Grouped 1x1 conv as a block-diagonal product.

    x: (..., Cin), kernel: (G, Cin // G, Cout // G) -> (..., Cout).
    Group g of the output reads only group g of the input.
    """
    groups, cin_g, cout_g = kernel.shape
    xg = x.reshape(*x.shape[:-1], groups, cin_g)
    yg = torch.einsum("...gc,gcd->...gd", xg, kernel)
    return yg.reshape(*x.shape[:-1], groups * cout_g).to(x.dtype)


def _dw_implementation() -> str:
    """The depthwise-conv route, from ``SENSORIUM_DW_IMPL`` (the counterpart
    of the JAX package's switch between its Pallas kernels and XLA's conv):

    * ``cuda`` (the default, unset or empty): the hand-written kernels of
      ``ops/dw_kernels.py`` (their plain versions for CPU tensors);
    * ``cudnn``: PyTorch's grouped ``conv3d``, with the library's backward.

    Any other value raises ``ValueError``: there is no silent choice.
    """
    impl = os.environ.get("SENSORIUM_DW_IMPL") or "cuda"
    if impl not in DW_IMPLEMENTATIONS:
        raise ValueError(f"SENSORIUM_DW_IMPL={impl!r}: expected one of {DW_IMPLEMENTATIONS}")
    return impl


def _grouped_conv3d(x: torch.Tensor, kernel: torch.Tensor, stride: tuple, padding: tuple) -> torch.Tensor:
    """The library route: x (B, T, H, W, C) as the (B, C, T, H, W) view of
    the same memory, ``kernel`` (C, 1, kt, kh, kw), one group a channel; the
    result is channels-last and contiguous, as the kernels' route gives it
    (a copy only where the library wrote another layout).

    On the CPU the input is copied to the contiguous (B, C, T, H, W) layout
    first: there PyTorch's bf16 weight gradient of the temporal conv reads
    uninitialized memory for a channels-last input and can return NaN
    (``tests/test_torch_dw_impl.py``)."""
    xc = x.permute(0, 4, 1, 2, 3)
    if xc.device.type == "cpu":
        xc = xc.contiguous()
    y = F.conv3d(xc, kernel, stride=stride, padding=padding, groups=x.shape[-1])
    return y.permute(0, 2, 3, 4, 1).contiguous()


def depthwise_conv_spatial(x: torch.Tensor, kernel: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """Depthwise (1, k, k) conv over (H, W) with torch "same" padding k // 2.

    x: (B, T, H, W, C), kernel: (k, k, C), cast to x's dtype. The output's
    spatial size is floor((S + 2*(k//2) - k) / stride) + 1, as torch Conv3d.
    The kernel's gradient is rounded to x's dtype before the cast back to
    the parameter's, as in the JAX package.
    """
    kernel = kernel.to(x.dtype)
    if _dw_implementation() == "cudnn":
        k, c = kernel.shape[0], kernel.shape[-1]
        weight = kernel.permute(2, 0, 1).reshape(c, 1, 1, k, k)
        return _grouped_conv3d(x, weight, (1, stride, stride), (0, k // 2, k // 2))
    return dw_spatial(x, kernel, stride)


def depthwise_conv_temporal(x: torch.Tensor, kernel: torch.Tensor) -> torch.Tensor:
    """Depthwise (k, 1, 1) conv over T with "same" padding, odd k.

    x: (B, T, H, W, C), kernel: (k, C), cast to x's dtype.
    """
    kernel = kernel.to(x.dtype)
    if _dw_implementation() == "cudnn":
        k, c = kernel.shape
        weight = kernel.t().reshape(c, 1, k, 1, 1)
        return _grouped_conv3d(x, weight, (1, 1, 1), (k // 2, 0, 0))
    return dw_temporal(x, kernel)


def eval_bn_runs_in_dw(*kernels: torch.Tensor) -> bool:
    """Whether an eval BN+SiLU runs inside the depthwise convs of these
    ``kernels``: on the kernels' route, for sizes they are compiled for. The
    ``cudnn`` route has no hand-written conv to run it in, and keeps the chain."""
    return _dw_implementation() == "cuda" and all(kernel.shape[0] in COMPILED_KS for kernel in kernels)


def depthwise_conv_spatial_bn(x: torch.Tensor, bn, kernel: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """``depthwise_conv_spatial`` of the eval ``BatchNorm`` ``bn`` with SiLU
    (``ops/norm.py``) of x, bitwise, without writing BN's output
    (``dw_kernels.dw_spatial_fwd_bn``). Forward only, as the eval BN is."""
    return dw_spatial_fwd_bn(x, kernel.to(x.dtype), bn.mean, bn.var, bn.scale, bn.bias, bn.eps, stride)


def depthwise_conv_temporal_bn(x: torch.Tensor, bn, kernel: torch.Tensor) -> torch.Tensor:
    """``depthwise_conv_temporal`` of the eval ``BatchNorm`` ``bn`` with SiLU
    of x, bitwise, without writing BN's output (``dw_kernels.dw_temporal_fwd_bn``)."""
    return dw_temporal_fwd_bn(x, kernel.to(x.dtype), bn.mean, bn.var, bn.scale, bn.bias, bn.eps)
