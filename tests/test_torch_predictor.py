"""The port's sliding-window Predictor against the JAX package's, on the CPU.

One tiny model (``tests.test_engine.tiny_params``) is built and saved by the
JAX engine, with its BN statistics and biases drawn from numpy so that they
matter; the JAX ``Predictor`` loads the checkpoint, and the port's
``Predictor`` gets the same weights through ``from_jax_variables``.
"""

from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from sensorium_tpu.engine.model import MouseModel
from sensorium_tpu.infer.predictor import Predictor as JaxPredictor
from sensorium_tpu_torch.compat import from_jax_variables
from sensorium_tpu_torch.infer.predictor import Predictor, assemble_trial_stack
from sensorium_tpu_torch.data.inputs import StackInputsProcessor
from sensorium_tpu_torch.models.registry import get_nn_module
from tests.test_engine import tiny_params


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    """(checkpoint path, eval params, eval batch stats) of one tiny model."""
    model = MouseModel(tiny_params())
    model.build_state(seed=0, learning_rate=0.0)
    rng = np.random.default_rng(0)

    def perturb(path, leaf):
        name, leaf = path[-1].key, np.asarray(leaf)
        if name == "var":
            return rng.uniform(0.5, 2.0, leaf.shape).astype(np.float32)
        if name in ("mean", "bias", "readout_bias"):
            return rng.normal(0, 0.3, leaf.shape).astype(np.float32)
        return leaf

    params = jax.tree_util.tree_map_with_path(perturb, jax.device_get(model.state.params))
    stats = jax.tree_util.tree_map_with_path(perturb, jax.device_get(model.state.batch_stats))
    model.state = model.state.replace(params=params, batch_stats=stats)
    path = tmp_path_factory.mktemp("ckpt") / "model-001-0.5.ckpt"
    model.save(str(path))
    return path, params, stats


def port_predictor(weights, blend_weights: str, chunk_size: int = 8) -> Predictor:
    _, params, stats = weights
    argus = tiny_params()
    nn_module = get_nn_module(*argus["nn_module"], device="cpu")
    nn_module.load_state_dict(from_jax_variables(params, stats), strict=True)
    return Predictor.from_module(nn_module, argus, blend_weights=blend_weights, chunk_size=chunk_size, device="cpu")


def trial(length: int, seed: int, frame=(12, 14)):
    rng = np.random.default_rng(seed)
    return (
        rng.uniform(0, 255, (*frame, length)).astype(np.float32),
        rng.uniform(0, 5, (2, length)).astype(np.float32),
        rng.uniform(0, 50, (2, length)).astype(np.float32),
    )


@pytest.mark.parametrize("blend_weights", ["ones", "linear"])
@pytest.mark.parametrize("length", [37, 48, 61])
def test_predict_trial_matches_jax(weights, length, blend_weights):
    video, behavior, pupil = trial(length, seed=length)
    expected = JaxPredictor(weights[0], blend_weights=blend_weights, chunk_size=8).predict_trial(
        video, behavior, pupil, mouse_index=1
    )
    got = port_predictor(weights, blend_weights).predict_trial(video, behavior, pupil, mouse_index=1)
    assert got.shape == expected.shape == (7, length)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, expected, rtol=1e-4, atol=1e-4)


def test_short_last_chunk_and_chunk_size_do_not_change_results(weights):
    video, behavior, pupil = trial(45, seed=1)
    a = port_predictor(weights, "ones", chunk_size=8).predict_trial(video, behavior, pupil, 0)
    b = port_predictor(weights, "ones", chunk_size=5).predict_trial(video, behavior, pupil, 0)
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_short_trial_gives_zeros(weights):
    predictor = port_predictor(weights, "ones")
    window = predictor.indexes_generator.width
    video, behavior, pupil = trial(window - 1, seed=2)
    out = predictor.predict_trial(video, behavior, pupil, mouse_index=0)
    assert out.shape == (5, window - 1) and np.all(out == 0.0)
    expected = JaxPredictor(weights[0], chunk_size=8).predict_trial(video, behavior, pupil, mouse_index=0)
    np.testing.assert_array_equal(out, expected)


def test_staged_trial_equals_predict_trial(weights):
    predictor = port_predictor(weights, "linear")
    video, behavior, pupil = trial(30, seed=3)
    staged = predictor.stage_trial(video, behavior, pupil)
    assert not staged.hoststack and staged.windows.shape == (30 - 6, 4)
    direct = predictor.predict_trial(video, behavior, pupil, 1)
    np.testing.assert_array_equal(predictor.run_staged(staged, 1).numpy(), direct)


def test_oversize_frames_take_the_host_stack_and_raise(weights):
    predictor = port_predictor(weights, "ones")
    video, behavior, pupil = trial(20, seed=4, frame=(18, 14))
    with pytest.raises(ValueError, match="exceeds the model canvas"):
        predictor.predict_trial(video, behavior, pupil, 0)


def test_device_assembly_equals_the_host_processor():
    video, behavior, pupil = trial(9, seed=5, frame=(11, 14))
    processor = StackInputsProcessor((16, 16), pad_fill_value=3.0)
    expected = processor(video, behavior, pupil)
    got = assemble_trial_stack(
        torch.from_numpy(np.ascontiguousarray(video.transpose(2, 0, 1))),
        torch.from_numpy(behavior),
        torch.from_numpy(pupil),
        16,
        16,
        3.0,
    )
    np.testing.assert_array_equal(got.numpy(), expected)


def test_predictor_refuses_what_the_jax_one_refuses(weights):
    nn_module = get_nn_module(*tiny_params()["nn_module"], device="cpu")
    bad_position = {**tiny_params(), "frame_stack": {"size": 4, "step": 2, "position": "middle"}}
    with pytest.raises(ValueError, match="last"):
        Predictor.from_module(nn_module, bad_position, device="cpu")
    with pytest.raises(ValueError, match="identity"):
        Predictor.from_module(nn_module, {**tiny_params(), "responses_processor": ("log", {})}, device="cpu")
    with pytest.raises(ValueError, match="chunk_size"):
        Predictor.from_module(nn_module, tiny_params(), chunk_size=0, device="cpu")
