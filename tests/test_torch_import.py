"""The port's import of reference PyTorch weights against the JAX package's.

``compat/torch_weights.py`` is a torch-only copy of the JAX package's
converter: on the golden reference state dict (``tests/golden/
dwiseneuro_small.npz``) both directions give the JAX package's arrays, leaf
for leaf. ``cli/import_torch.convert_checkpoint`` writes the file the JAX
package's writes, byte for byte, and both packages' ``load_model`` read it
and predict alike (``tests/test_torch_model.py``'s tolerances).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from sensorium_tpu.cli.import_torch import convert_checkpoint as jax_convert_checkpoint
from sensorium_tpu.compat import convert_torch_state_dict as jax_convert
from sensorium_tpu.compat import to_torch_state_dict as jax_to_torch
from sensorium_tpu.engine.model import load_model as jax_load_model
from sensorium_tpu_torch.cli import import_torch
from sensorium_tpu_torch.compat import convert_torch_state_dict, to_torch_state_dict
from sensorium_tpu_torch.engine.model import load_model
from sensorium_tpu_torch.infer.predictor import Predictor
from sensorium_tpu_torch.models.dwiseneuro import padded_group_size
from tests.test_model_parity import GOLDEN_PATH, MODEL_KWARGS, READOUT_OUTPUTS, torch_state_dict

RTOL, ATOL = 1e-4, 1e-5  # tests/test_torch_model.py
LAYOUT = dict(readout_outputs=list(READOUT_OUTPUTS), num_core_blocks=2, num_cortex_layers=2, groups=2)


@pytest.fixture(scope="module")
def reference_state():
    golden = np.load(GOLDEN_PATH)
    return {key: torch.from_numpy(np.asarray(value)) for key, value in torch_state_dict(golden, "sd0").items()}


def assert_trees_equal(got, expected, path="tree"):
    if isinstance(expected, dict):
        assert isinstance(got, dict) and got.keys() == expected.keys(), path
        for key in expected:
            assert_trees_equal(got[key], expected[key], f"{path}.{key}")
    else:
        got, expected = np.asarray(got), np.asarray(expected)
        assert got.dtype == expected.dtype and got.shape == expected.shape, path
        np.testing.assert_array_equal(got, expected, err_msg=path)


def test_converters_match_jax_leaf_for_leaf(reference_state):
    pad = padded_group_size(READOUT_OUTPUTS, 2, MODEL_KWARGS["readout_pad_multiple"])
    assert pad == 8
    params, stats = convert_torch_state_dict(reference_state, padded_group_size=pad, **LAYOUT)
    jax_params, jax_stats = jax_convert(reference_state, padded_group_size=pad, **LAYOUT)
    assert_trees_equal(params, jax_params)
    assert_trees_equal(stats, jax_stats)
    back = to_torch_state_dict(params, stats, **LAYOUT)
    assert_trees_equal(back, jax_to_torch(jax_params, jax_stats, **LAYOUT))
    for key, value in reference_state.items():
        if "inv_freq" not in key and "num_batches_tracked" not in key:
            np.testing.assert_array_equal(np.asarray(back[key]).reshape(value.shape), value.numpy(), err_msg=key)


def make_reference_pth(state: dict, path) -> None:
    nn_kwargs = {key: value for key, value in MODEL_KWARGS.items() if key != "dtype"}
    argus_params = {
        "nn_module": ("dwiseneuro", nn_kwargs),
        "loss": ("mice_poisson", {"log_input": False, "full": False, "eps": 1e-8}),
        "optimizer": ("AdamW", {"lr": 1e-3, "weight_decay": 0.05}),
        "device": "cuda:0",
        "frame_stack": {"size": 4, "step": 2, "position": "last"},
        "inputs_processor": ("stack_inputs", {"size": (16, 16), "pad_fill_value": 0.0}),
        "responses_processor": ("identity", {}),
        "amp": True,
        "iter_size": 1,
    }
    torch.save({"model_name": "MouseModel", "params": argus_params, "nn_state_dict": state}, path)


def test_convert_checkpoint_is_read_by_both_packages(reference_state, tmp_path, capsys):
    pth = tmp_path / "model-011-0.123456.pth"
    make_reference_pth(reference_state, pth)
    ckpt = tmp_path / "port" / "model-011-0.123456.ckpt"
    import_torch.main([str(pth), str(ckpt), "--dtype", "float32"])
    assert "Converted" in capsys.readouterr().out
    jax_ckpt = tmp_path / "jax" / "model-011-0.123456.ckpt"
    returned = jax_convert_checkpoint(pth, jax_ckpt, dtype="float32")
    assert ckpt.read_bytes() == jax_ckpt.read_bytes()
    assert import_torch.convert_checkpoint(pth, tmp_path / "again.ckpt", dtype="float32") == returned

    inputs = np.random.default_rng(0).uniform(0, 255, (2, 5, 4, 16, 16)).astype(np.float32)
    port_model, jax_model = load_model(ckpt, device="cpu"), jax_load_model(ckpt)
    for mouse in range(len(READOUT_OUTPUTS)):
        got = port_model.predict(inputs, mouse_index=mouse).numpy()
        assert got.shape == (2, READOUT_OUTPUTS[mouse], 4) and np.isfinite(got).all() and (got >= 0).all()
        np.testing.assert_allclose(got, np.asarray(jax_model.predict(inputs, mouse_index=mouse)), rtol=RTOL,
                                   atol=ATOL)

    rng = np.random.default_rng(1)
    trial = (rng.uniform(0, 255, (12, 16, 20)).astype(np.float32), rng.uniform(0, 5, (2, 20)).astype(np.float32),
             rng.uniform(50, 200, (2, 20)).astype(np.float32))
    prediction = Predictor(ckpt, chunk_size=8, device="cpu").predict_trial(*trial, mouse_index=1)
    assert prediction.shape == (READOUT_OUTPUTS[1], 20) and np.isfinite(prediction).all()
