"""Weights of the PyTorch reference implementation, in and out of the port.

A copy of ``sensorium_tpu/compat/torch_weights.py`` (numpy only). The
reference saves checkpoints as ``{model_name, params, nn_state_dict}`` with
its own parameter names and layouts; ``convert_torch_state_dict`` maps that
state dict onto the JAX tree (``params``, ``batch_stats``), which is the
port's own naming (``compat/jax_weights.py``), and ``to_torch_state_dict``
maps it back.

Layout conversions (reference -> JAX tree):
  1x1x1 Conv3d  (out, in, 1, 1, 1)      -> (in, out)
  spatial dw    (mid, 1, 1, k, k)       -> (k, k, mid)
  temporal dw   (mid, 1, k, 1, 1)       -> (k, mid)
  grouped Conv1d (out, in/g, 1)         -> (g, in/g, out/g)
  readout Conv1d (ceil(N/g)*g, in/g, 1) -> rows of the stacked padded
                                           (M, g, in/g, P) kernel
  BatchNorm weight/bias/running_mean/var -> scale/bias + batch_stats
"""

from __future__ import annotations

import math

import numpy as np


def _np(tensor) -> np.ndarray:
    if hasattr(tensor, "detach"):
        tensor = tensor.detach().cpu().numpy()
    return np.asarray(tensor, dtype=np.float32)


def _bn(sd: dict, prefix: str):
    params = {"scale": _np(sd[f"{prefix}.weight"]), "bias": _np(sd[f"{prefix}.bias"])}
    stats = {"mean": _np(sd[f"{prefix}.running_mean"]), "var": _np(sd[f"{prefix}.running_var"])}
    return params, stats


def _pw(sd: dict, key: str) -> np.ndarray:
    return _np(sd[key])[:, :, 0, 0, 0].T  # (out, in, 1,1,1) -> (in, out)


def _grouped_1d(weight: np.ndarray, groups: int) -> np.ndarray:
    out_ch, in_g = weight.shape[0], weight.shape[1]
    return weight[:, :, 0].reshape(groups, out_ch // groups, in_g).transpose(0, 2, 1)


def convert_torch_state_dict(
    state_dict: dict,
    readout_outputs: list[int],
    num_core_blocks: int,
    num_cortex_layers: int,
    groups: int,
    padded_group_size: int,
) -> tuple[dict, dict]:
    """Returns the (params, batch_stats) trees of DwiseNeuro."""
    sd = state_dict
    params: dict = {}
    stats: dict = {}

    params["stem_kernel"] = _pw(sd, "core.stem.0.weight")
    params["stem_bn"], stats["stem_bn"] = {}, {}
    params["stem_bn"]["bn"], stats["stem_bn"]["bn"] = _bn(sd, "core.stem.1.bn")

    for i in range(num_core_blocks):
        # blocks alternate [PositionalEncoding, InvertedResidual3d]
        t = f"core.blocks.{2 * i + 1}"
        block_p: dict = {}
        block_s: dict = {}
        block_p["pw_kernel"] = _pw(sd, f"{t}.conv_pw.0.weight")
        block_p["pw_bn"] = {"bn": _bn(sd, f"{t}.conv_pw.1.bn")[0]}
        block_s["pw_bn"] = {"bn": _bn(sd, f"{t}.conv_pw.1.bn")[1]}
        sp = _np(sd[f"{t}.spat_covn_dw.0.weight"])  # (mid, 1, 1, k, k)
        block_p["spatial_dw_kernel"] = sp[:, 0, 0].transpose(1, 2, 0)
        block_p["spatial_bn"] = {"bn": _bn(sd, f"{t}.spat_covn_dw.1.bn")[0]}
        block_s["spatial_bn"] = {"bn": _bn(sd, f"{t}.spat_covn_dw.1.bn")[1]}
        tm = _np(sd[f"{t}.temp_covn_dw.0.weight"])  # (mid, 1, k, 1, 1)
        block_p["temporal_dw_kernel"] = tm[:, 0, :, 0, 0].T
        block_p["temporal_bn"] = {"bn": _bn(sd, f"{t}.temp_covn_dw.1.bn")[0]}
        block_s["temporal_bn"] = {"bn": _bn(sd, f"{t}.temp_covn_dw.1.bn")[1]}
        block_p["se"] = {
            "reduce_kernel": _pw(sd, f"{t}.se.conv_reduce.weight"),
            "reduce_bias": _np(sd[f"{t}.se.conv_reduce.bias"]),
            "expand_kernel": _pw(sd, f"{t}.se.conv_expand.weight"),
            "expand_bias": _np(sd[f"{t}.se.conv_expand.bias"]),
        }
        block_p["pwl_kernel"] = _pw(sd, f"{t}.conv_pwl.0.weight")
        block_p["pwl_bn"] = {"bn": _bn(sd, f"{t}.conv_pwl.1.bn")[0]}
        block_s["pwl_bn"] = {"bn": _bn(sd, f"{t}.conv_pwl.1.bn")[1]}
        block_p["bn_sc"] = {"bn": _bn(sd, f"{t}.bn_sc.bn")[0]}
        block_s["bn_sc"] = {"bn": _bn(sd, f"{t}.bn_sc.bn")[1]}
        params[f"block_{i}"] = block_p
        stats[f"block_{i}"] = block_s

    for i in range(num_cortex_layers):
        t = f"cortex.layers.{i}"
        layer_p: dict = {"kernel": _grouped_1d(_np(sd[f"{t}.conv.weight"]), groups)}
        layer_s: dict = {}
        layer_p["bn"] = {"bn": _bn(sd, f"{t}.bn.bn")[0]}
        layer_s["bn"] = {"bn": _bn(sd, f"{t}.bn.bn")[1]}
        layer_p["bn_sc"] = {"bn": _bn(sd, f"{t}.bn_sc.bn")[0]}
        layer_s["bn_sc"] = {"bn": _bn(sd, f"{t}.bn_sc.bn")[1]}
        params[f"cortex_{i}"] = layer_p
        stats[f"cortex_{i}"] = layer_s

    num_mice = len(readout_outputs)
    cin_g = _np(sd["readouts.0.layer.1.weight"]).shape[1]
    kernel = np.zeros((num_mice, groups, cin_g, padded_group_size), dtype=np.float32)
    bias = np.zeros((num_mice, groups, padded_group_size), dtype=np.float32)
    for m, n in enumerate(readout_outputs):
        per_group = math.ceil(n / groups)
        w = _grouped_1d(_np(sd[f"readouts.{m}.layer.1.weight"]), groups)
        kernel[m, :, :, :per_group] = w
        b = _np(sd[f"readouts.{m}.layer.1.bias"]).reshape(groups, per_group)
        bias[m, :, :per_group] = b
    params["readout_kernel"] = kernel
    params["readout_bias"] = bias

    return params, stats


def _bn_out(sd: dict, prefix: str, params: dict, stats: dict) -> None:
    sd[f"{prefix}.weight"] = _np(params["scale"])
    sd[f"{prefix}.bias"] = _np(params["bias"])
    sd[f"{prefix}.running_mean"] = _np(stats["mean"])
    sd[f"{prefix}.running_var"] = _np(stats["var"])
    sd[f"{prefix}.num_batches_tracked"] = np.zeros((), np.int64)


def _pw_out(kernel) -> np.ndarray:
    return _np(kernel).T[:, :, None, None, None]  # (in, out) -> (out, in, 1,1,1)


def _grouped_1d_out(kernel: np.ndarray) -> np.ndarray:
    # (g, in_g, out_g) -> (out, in_g, 1)
    k = _np(kernel)
    return k.transpose(0, 2, 1).reshape(-1, k.shape[1])[:, :, None]


def to_torch_state_dict(
    params: dict,
    batch_stats: dict,
    readout_outputs: list[int],
    num_core_blocks: int,
    num_cortex_layers: int,
    groups: int,
) -> dict:
    """Inverse of ``convert_torch_state_dict``: the (params, batch_stats)
    trees -> a reference-format torch ``state_dict`` (numpy values; wrap with
    ``torch.from_numpy`` to load).  Lets a model trained here be exported
    back into the reference PyTorch stack (two-way checkpoint
    compatibility; layout table in the module docstring).  Padded readout
    rows are dropped (they are exactly-zero by construction)."""
    p, s = params, batch_stats
    sd: dict = {}
    sd["core.stem.0.weight"] = _pw_out(p["stem_kernel"])
    _bn_out(sd, "core.stem.1.bn", p["stem_bn"]["bn"], s["stem_bn"]["bn"])

    # PositionalEncoding3d registers a deterministic inv_freq buffer at the
    # even block slots (dwiseneuro.py:148-156); recompute it from the
    # block's input channel count (= its pw kernel's fan-in).
    for i in range(num_core_blocks):
        channels = int(np.asarray(p[f"block_{i}"]["pw_kernel"]).shape[0])
        per_axis = math.ceil(channels / 6) * 2
        if per_axis % 2:
            per_axis += 1
        sd[f"core.blocks.{2 * i}.inv_freq"] = (
            1.0 / (10000 ** (np.arange(0, per_axis, 2, dtype=np.float32) / per_axis))
        ).astype(np.float32)

    for i in range(num_core_blocks):
        t = f"core.blocks.{2 * i + 1}"
        bp, bs = p[f"block_{i}"], s[f"block_{i}"]
        sd[f"{t}.conv_pw.0.weight"] = _pw_out(bp["pw_kernel"])
        _bn_out(sd, f"{t}.conv_pw.1.bn", bp["pw_bn"]["bn"], bs["pw_bn"]["bn"])
        sp = _np(bp["spatial_dw_kernel"])  # (k, k, mid)
        sd[f"{t}.spat_covn_dw.0.weight"] = sp.transpose(2, 0, 1)[:, None, None]
        _bn_out(sd, f"{t}.spat_covn_dw.1.bn", bp["spatial_bn"]["bn"], bs["spatial_bn"]["bn"])
        tm = _np(bp["temporal_dw_kernel"])  # (k, mid)
        sd[f"{t}.temp_covn_dw.0.weight"] = tm.T[:, None, :, None, None]
        _bn_out(sd, f"{t}.temp_covn_dw.1.bn", bp["temporal_bn"]["bn"], bs["temporal_bn"]["bn"])
        sd[f"{t}.se.conv_reduce.weight"] = _pw_out(bp["se"]["reduce_kernel"])
        sd[f"{t}.se.conv_reduce.bias"] = _np(bp["se"]["reduce_bias"])
        sd[f"{t}.se.conv_expand.weight"] = _pw_out(bp["se"]["expand_kernel"])
        sd[f"{t}.se.conv_expand.bias"] = _np(bp["se"]["expand_bias"])
        sd[f"{t}.conv_pwl.0.weight"] = _pw_out(bp["pwl_kernel"])
        _bn_out(sd, f"{t}.conv_pwl.1.bn", bp["pwl_bn"]["bn"], bs["pwl_bn"]["bn"])
        _bn_out(sd, f"{t}.bn_sc.bn", bp["bn_sc"]["bn"], bs["bn_sc"]["bn"])

    for i in range(num_cortex_layers):
        t = f"cortex.layers.{i}"
        lp, ls = p[f"cortex_{i}"], s[f"cortex_{i}"]
        sd[f"{t}.conv.weight"] = _grouped_1d_out(lp["kernel"])
        _bn_out(sd, f"{t}.bn.bn", lp["bn"]["bn"], ls["bn"]["bn"])
        _bn_out(sd, f"{t}.bn_sc.bn", lp["bn_sc"]["bn"], ls["bn_sc"]["bn"])

    kernel = _np(p["readout_kernel"])  # (M, g, cin_g, P)
    bias = _np(p["readout_bias"])  # (M, g, P)
    for m, n in enumerate(readout_outputs):
        per_group = math.ceil(n / groups)
        w = kernel[m, :, :, :per_group]  # (g, cin_g, per)
        sd[f"readouts.{m}.layer.1.weight"] = (
            w.transpose(0, 2, 1).reshape(-1, w.shape[1])[:, :, None]
        )
        sd[f"readouts.{m}.layer.1.bias"] = bias[m, :, :per_group].reshape(-1)
    return sd
