"""The port's DwiseNeuro eval forward against the JAX package's, on the CPU.

The toy configuration of ``tests/test_model_parity.py`` is initialised by the
JAX ``DwiseNeuro.init``, its BN statistics and biases are drawn from numpy
with a seed (so every BN and bias term matters), and the variables move into
the port with ``from_jax_variables``, loaded strictly. Both sides run in fp32.
The torch goldens of ``tests/golden/dwiseneuro_small.npz`` are a second
reference.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from sensorium_tpu.compat import convert_torch_state_dict
from sensorium_tpu.models.dwiseneuro import DwiseNeuro as JaxDwiseNeuro
from sensorium_tpu_torch.compat import from_jax_variables
from sensorium_tpu_torch.models.dwiseneuro import DwiseNeuro, readout_group_sizes
from sensorium_tpu_torch.models.registry import get_nn_module
from tests.test_model_parity import GOLDEN_PATH, MODEL_KWARGS, READOUT_OUTPUTS, torch_state_dict

REPO = Path(__file__).resolve().parents[1]
TORCH_KWARGS = {**MODEL_KWARGS, "dtype": torch.float32}


def perturbed_variables(kwargs: dict, seed: int, shape=(2, 5, 8, 16, 16)) -> dict:
    """JAX init, then random BN scale/bias/mean/var and readout bias."""
    variables = JaxDwiseNeuro(**kwargs).init(jax.random.PRNGKey(seed), jnp.zeros(shape, jnp.float32))
    rng = np.random.default_rng(seed)

    def perturb(path, leaf):
        name = path[-1].key
        leaf = np.asarray(leaf)
        if name == "var":
            return rng.uniform(0.5, 2.0, leaf.shape).astype(np.float32)
        if name == "scale":
            return rng.uniform(0.5, 1.5, leaf.shape).astype(np.float32)
        if name in ("mean", "bias", "reduce_bias", "expand_bias", "readout_bias"):
            return rng.normal(0, 0.3, leaf.shape).astype(np.float32)
        return leaf

    return jax.tree_util.tree_map_with_path(perturb, jax.device_get(variables))


def port_model(kwargs: dict, variables: dict) -> DwiseNeuro:
    model = DwiseNeuro(**{**kwargs, "dtype": torch.float32}).eval()
    model.load_state_dict(from_jax_variables(variables["params"], variables["batch_stats"]), strict=True)
    return model


def assert_matches_jax(kwargs: dict, variables: dict, x: np.ndarray) -> None:
    jax_model = JaxDwiseNeuro(**kwargs)
    model = port_model(kwargs, variables)
    readouts = kwargs["readout_outputs"]
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
        got_single = [model(torch.from_numpy(x), mouse_index=m).numpy() for m in range(len(readouts))]
    expected = np.asarray(jax_model.apply(variables, x, train=False))
    assert got.shape == expected.shape == (len(readouts), x.shape[0], max(readouts), x.shape[2])
    for mouse, num in enumerate(readouts):
        np.testing.assert_allclose(got[mouse][:, :num], expected[mouse][:, :num], rtol=1e-4, atol=1e-5)
        assert np.all(got[mouse][:, num:] == 0.0)
        single = np.asarray(jax_model.apply(variables, x, mouse_index=mouse, train=False))
        np.testing.assert_allclose(got_single[mouse], single, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("hw", [(16, 16), (15, 13)])
def test_eval_forward_matches_jax(hw):
    """(16, 16) takes the strided-slice shortcut, (15, 13) the nearest-index one."""
    shape = (2, 5, 8, *hw)
    variables = perturbed_variables(MODEL_KWARGS, seed=0, shape=shape)
    x = np.random.default_rng(1).uniform(0, 255, shape).astype(np.float32)
    assert_matches_jax(MODEL_KWARGS, variables, x)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_eval_blocks_run_pw_bn_and_spatial_bn_inside_the_depthwise_convs(monkeypatch, dtype):
    """An eval forward runs each block's pw_bn and spatial_bn inside its
    depthwise convs (``ops/conv.py`` ``depthwise_conv_*_bn``), and gives the
    chain through the same modules' BatchNormAct and conv calls bit for bit;
    a training forward keeps the chain."""
    from sensorium_tpu_torch.models import dwiseneuro

    variables = perturbed_variables(MODEL_KWARGS, seed=4)
    model = DwiseNeuro(**{**MODEL_KWARGS, "dtype": dtype}).eval()
    model.load_state_dict(from_jax_variables(variables["params"], variables["batch_stats"]), strict=True)
    calls = {"spatial": 0, "temporal": 0, "spatial_bn": 0, "temporal_bn": 0}

    def counted(name):
        fn = getattr(dwiseneuro, f"depthwise_conv_{name}")

        def call(*args):
            calls[name] += 1
            return fn(*args)

        monkeypatch.setattr(dwiseneuro, f"depthwise_conv_{name}", call)

    for name in calls:
        counted(name)
    x = torch.from_numpy(np.random.default_rng(5).uniform(0, 255, (2, 5, 8, 16, 16)).astype(np.float32))
    blocks = model.num_blocks
    with torch.no_grad():
        folded = model(x)
        assert calls == {"spatial": 0, "temporal": 0, "spatial_bn": blocks, "temporal_bn": blocks}
        with monkeypatch.context() as patch:
            patch.setattr(dwiseneuro, "eval_bn_runs_in_dw", lambda *kernels: False)
            chain = model(x)
        assert calls == {"spatial": blocks, "temporal": blocks, "spatial_bn": blocks, "temporal_bn": blocks}
        model.train()(x, generator=torch.Generator().manual_seed(0))
        assert calls["spatial"] == 2 * blocks and calls["spatial_bn"] == blocks
    assert folded.dtype == torch.float32 and torch.equal(folded, chain)


def test_learnable_softplus_matches_jax():
    kwargs = {**MODEL_KWARGS, "learnable_softplus": True}
    variables = perturbed_variables(kwargs, seed=2)
    variables["params"]["readout_softplus_beta"] = np.array([0.05, 0.07, 0.11], np.float32)
    x = np.random.default_rng(3).uniform(0, 255, (2, 5, 8, 16, 16)).astype(np.float32)
    assert_matches_jax(kwargs, variables, x)


def test_golden_torch_reference_outputs():
    golden = np.load(GOLDEN_PATH)
    base = JaxDwiseNeuro(**MODEL_KWARGS)
    params, stats = convert_torch_state_dict(
        torch_state_dict(golden, "sd0"),
        readout_outputs=list(READOUT_OUTPUTS),
        num_core_blocks=2,
        num_cortex_layers=2,
        groups=2,
        padded_group_size=base.padded_group_size,
    )
    model = port_model(MODEL_KWARGS, {"params": params, "batch_stats": stats})
    x = torch.from_numpy(golden["input"])
    with torch.no_grad():
        out = model(x).numpy()
        single = model(x, mouse_index=1).numpy()
    for mouse, num in enumerate(READOUT_OUTPUTS):
        np.testing.assert_allclose(out[mouse][:, :num], golden[f"eval_out:{mouse}"], rtol=1e-4, atol=1e-5)
        assert np.all(out[mouse][:, num:] == 0.0)
    np.testing.assert_allclose(single, golden["eval_mouse1"], rtol=1e-4, atol=1e-5)


def test_state_dict_keeps_the_jax_tree():
    """Same names and shapes as the flattened JAX variables, nothing more."""
    variables = jax.device_get(
        JaxDwiseNeuro(**MODEL_KWARGS).init(jax.random.PRNGKey(0), jnp.zeros((1, 5, 8, 16, 16)))
    )
    state = from_jax_variables(variables["params"], variables["batch_stats"])
    expected = {k: tuple(v.shape) for k, v in state.items()}
    got = {k: tuple(v.shape) for k, v in DwiseNeuro(**TORCH_KWARGS).state_dict().items()}
    assert got == expected
    assert got["block_0.spatial_dw_kernel"] == (3, 3, 16)
    assert got["readout_kernel"] == (3, 2, 12, 8)


def test_init_is_kaiming_normal_from_the_generator():
    a = DwiseNeuro(**TORCH_KWARGS, generator=torch.Generator().manual_seed(5)).state_dict()
    b = DwiseNeuro(**TORCH_KWARGS, generator=torch.Generator().manual_seed(5)).state_dict()
    c = DwiseNeuro(**TORCH_KWARGS, generator=torch.Generator().manual_seed(6)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["block_0.pw_kernel"], c["block_0.pw_kernel"])
    big = DwiseNeuro(**{**TORCH_KWARGS, "core_features": (64, 64), "expansion_ratio": 8}).state_dict()
    # std sqrt(2 / fan_out), fan_out = the output width (512 here)
    assert abs(big["block_0.pw_kernel"].std().item() - (2 / 512) ** 0.5) < 0.05 * (2 / 512) ** 0.5
    assert torch.all(big["block_0.pw_bn.bn.var"] == 1) and torch.all(big["readout_bias"] == 0)


@pytest.mark.parametrize("mouse_index", [None, 1])
def test_training_forward_matches_jax(mouse_index):
    """Drop rates 0: the training forward (BN batch statistics) and the
    running statistics it leaves, against the JAX ``train=True`` apply."""
    shape = (2, 5, 8, 16, 16)
    variables = perturbed_variables(MODEL_KWARGS, seed=6, shape=shape)
    x = np.random.default_rng(7).uniform(0, 255, shape).astype(np.float32)
    expected, mutated = JaxDwiseNeuro(**MODEL_KWARGS).apply(variables, x, mouse_index=mouse_index, train=True,
                                                            mutable=["batch_stats"])
    model = port_model(MODEL_KWARGS, variables).train()
    with torch.no_grad():
        got = model(torch.from_numpy(x), mouse_index=mouse_index).numpy()
    np.testing.assert_allclose(got, np.asarray(expected), rtol=1e-4, atol=1e-5)
    stats = from_jax_variables({}, mutated["batch_stats"])
    buffers = dict(model.named_buffers())
    assert set(stats) == set(buffers)
    for name, value in stats.items():
        # The stem BN's first one-pass variance cancels ~(mean/std)^2 digits
        # of 0-255 video on both sides (tests/test_torch_train_step.py).
        np.testing.assert_allclose(buffers[name].numpy(), value.numpy(), rtol=1e-4, atol=1e-6, err_msg=name)


def test_readout_group_sizes():
    assert readout_group_sizes(11, 2) == [6, 5]
    assert readout_group_sizes(7, 3) == [3, 3, 1]
    assert readout_group_sizes(2, 4) == [1, 1, 0, 0]


def test_registry_reads_config_dtypes():
    params = {**MODEL_KWARGS, "dtype": "bfloat16"}
    model = get_nn_module("dwiseneuro", params, device="cpu")
    assert model.dtype == torch.bfloat16 and not model.training
    assert model.stem_kernel.dtype == torch.float32  # parameters stay fp32
    with torch.no_grad():
        out = model(torch.zeros(1, 5, 8, 16, 16), mouse_index=0)
    assert out.dtype == torch.float32 and out.shape == (1, 11, 8)
    with pytest.raises(ValueError, match="float16"):
        get_nn_module("dwiseneuro", {**MODEL_KWARGS, "dtype": "float16"}, device="cpu")
    with pytest.raises(KeyError):
        get_nn_module("resnet", {}, device="cpu")


def test_chip_smoke_bn_calls_are_the_flagship_forwards_bns():
    """chip_smoke's flagship_bn_calls (phase 9b's shapes, the BN launch
    counts) name every BatchNormAct of a flagship forward with its (rows, C)
    and SiLU, read by hooks on a training forward of one 2-frame window."""
    from sensorium_tpu_torch.models.dwiseneuro import BatchNormAct

    name, params = chip_smoke.FLAGSHIP_NN_MODULE
    model = get_nn_module(name, {**params, "dtype": "float32"}, device="cpu")
    seen = {}
    for module_name, module in model.named_modules():
        if isinstance(module, BatchNormAct):
            def record(m, args, module_name=module_name):
                seen[module_name] = (args[0].numel() // args[0].shape[-1], args[0].shape[-1], m.act)

            module.register_forward_pre_hook(record)
    size = chip_smoke.FLAGSHIP_ARGUS["inputs_processor"][1]["size"]
    with torch.no_grad():
        model.train()(torch.zeros(1, params["in_channels"], 2, *size), generator=torch.Generator().manual_seed(0))
    calls = chip_smoke.flagship_bn_calls(1, 2)
    assert {c["name"]: (c["rows"], c["c"], c["act"]) for c in calls} == seen
    assert len(calls) == 52


def test_chip_smoke_flagship_matches_the_config():
    spec = importlib.util.spec_from_file_location("true_batch_001", REPO / "configs" / "true_batch_001.py")
    config = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(config)
    name, params = config.config["argus_params"]["nn_module"]
    assert chip_smoke.FLAGSHIP_NN_MODULE == (name, {**params, "readout_outputs": list(params["readout_outputs"])})
    argus = config.config["argus_params"]
    for key in ("frame_stack", "inputs_processor", "responses_processor"):
        assert chip_smoke.FLAGSHIP_ARGUS[key] == argus[key]
    for key in ("loss", "optimizer", "iter_size"):
        assert chip_smoke.FLAGSHIP_TRAIN_ARGUS[key] == argus[key]
    assert chip_smoke.TRAIN_BATCH == config.config["batch_size"]
    assert chip_smoke.EMA_DECAY == config.config["ema_decay"]
