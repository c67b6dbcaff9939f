"""The plain reference against the program's plain CPU path, at a toy size
in float32: the eval and training forwards, the loss and the distillation
targets, the gradients, the batch assembly and whole-trial prediction.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark.harness.weights import make_weights
from benchmark.reference import data as ref_data
from benchmark.reference import model as ref
from benchmark.reference import train as ref_train
from benchmark.tests.toy import TOY_NN

CPU = torch.device("cpu")


def program_module(cfg, seed):
    from sensorium_tpu_torch.models.registry import get_nn_module

    module = get_nn_module("dwiseneuro", cfg, device="cpu")
    module.load_state_dict(make_weights(cfg, seed, CPU), strict=True)
    return module


def inputs(seed, batch=4, frames=4, size=16):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 255, (batch, 5, frames, size, size)).astype(np.float32)
    x[:, 1:3] = rng.uniform(0, 5, (batch, 2, frames, 1, 1))
    return torch.from_numpy(x)


@pytest.mark.parametrize("mouse", [None, 0, 9])
def test_eval_forward_matches_program(mouse):
    weights = make_weights(TOY_NN, 3, CPU)
    module = program_module(TOY_NN, 3)
    x = inputs(0)
    with torch.no_grad():
        expected = ref.forward(weights, x, TOY_NN, mouse=mouse)
        got = module.eval()(x, mouse_index=mouse)
    assert got.shape == expected.shape
    torch.testing.assert_close(got, expected, rtol=1e-5, atol=1e-5 * float(expected.abs().max()))


def test_training_forward_loss_and_gradients_match_program():
    from sensorium_tpu_torch.engine.losses import mice_poisson_loss

    cfg = dict(TOY_NN)
    weights = make_weights(cfg, 4, CPU)
    module = program_module(cfg, 4).train()
    x = inputs(1)
    rng = np.random.default_rng(2)
    targets = torch.from_numpy(rng.gamma(1.5, 1.0, (4, max(cfg["readout_outputs"]), 4)).astype(np.float32))
    row_weights = torch.zeros(4, 10)
    row_weights[torch.arange(4), torch.tensor([0, 3, 3, 9])] = 1.0

    got = module(x, generator=torch.Generator().manual_seed(11))
    loss = mice_poisson_loss(got.float(), targets, row_weights)
    loss.backward()

    params = {n: t.clone().requires_grad_(True) for n, t in weights.items()}
    stats = {}
    masks = ref.draw_masks(cfg, 4, torch.Generator().manual_seed(11), CPU)
    expected = ref.forward(params, x, cfg, train=True, masks=masks, stats=stats, checkpoint_blocks=True)
    expected_loss = ref_train.poisson_loss(expected, targets, row_weights)
    expected_loss.backward()
    torch.testing.assert_close(got, expected, rtol=1e-5, atol=1e-5 * float(expected.detach().abs().max()))
    torch.testing.assert_close(loss, expected_loss, rtol=1e-5, atol=0)
    largest = max(float(p.grad.abs().max()) for p in params.values() if p.grad is not None)
    for name, p in module.named_parameters():
        g, e = p.grad, params[name].grad
        # A leaf whose gradient is nought to rounding (a bias under the next
        # BN's batch mean) is held to the model's largest gradient.
        torch.testing.assert_close(g, e, rtol=1e-4, atol=1e-4 * float(e.abs().max()) + 1e-6 * largest, msg=name)
    ref.update_running_stats(params, stats)
    for name, buf in module.named_buffers():
        if name in params:
            torch.testing.assert_close(buf, params[name].detach(), rtol=1e-5, atol=1e-6, msg=name)


def test_distillation_targets_match_program():
    from sensorium_tpu_torch.engine.losses import inject_distill_targets

    rng = np.random.default_rng(5)
    target = torch.from_numpy(rng.gamma(1.5, 1.0, (6, 7, 4)).astype(np.float32))
    teacher = torch.from_numpy(rng.gamma(1.5, 1.0, (10, 6, 7, 4)).astype(np.float32))
    weights = torch.zeros(6, 10)
    weights[torch.arange(6), torch.tensor([1, 2, 2, 5, 8, 0])] = 1.0
    for got, expected in zip(inject_distill_targets(target, weights, teacher, 0.36),
                             ref_train.distill_targets(target, weights, teacher, 0.36)):
        torch.testing.assert_close(got, expected, rtol=0, atol=0)


def test_adamw_and_cosine_match_torch():
    from sensorium_tpu_torch.engine.schedule import build_stage_schedule

    rng = np.random.default_rng(6)
    p0 = torch.from_numpy(rng.normal(size=(5, 3)).astype(np.float32))
    grads = [torch.from_numpy(rng.normal(size=(5, 3)).astype(np.float32)) for _ in range(3)]
    plan = (2.4e-3, 2.4e-5, 0, 100)
    schedule = build_stage_schedule(*plan)
    param = torch.nn.Parameter(p0.clone())
    optimizer = torch.optim.AdamW([param], lr=1.0, weight_decay=0.05)
    params, state = {"w": p0.clone()}, {}
    for count, g in enumerate(grads):
        optimizer.param_groups[0]["lr"] = schedule(count)
        param.grad = g.clone()
        optimizer.step()
        ref_train.adamw_step(params, {"w": g}, state, ref_train.cosine_lr(count, *plan), 0.05)
        assert schedule(count) == pytest.approx(ref_train.cosine_lr(count, *plan), rel=1e-12)
    torch.testing.assert_close(param.detach(), params["w"], rtol=1e-6, atol=1e-7)


def test_batch_assembly_matches_program_loader(tmp_path):
    from sensorium_tpu_torch import constants
    from sensorium_tpu_torch.data import mouse_data
    from sensorium_tpu_torch.data.datasets import TrainMiceDataset
    from sensorium_tpu_torch.data.indexes import WindowIndexer
    from sensorium_tpu_torch.data.inputs import get_inputs_processor
    from sensorium_tpu_torch.data.loader import MiceDataLoader
    from sensorium_tpu_torch.data.mixers import CutMix
    from sensorium_tpu_torch.data.responses import get_responses_processor

    from benchmark.harness import synth

    neurons = TOY_NN["readout_outputs"]
    tree = synth.write_tree(tmp_path, constants.mice, neurons, 3, 40, (12, 16), 8, CPU)
    saved = constants.sensorium_dir
    frame_stack = {"size": 4, "step": 2, "position": "last"}
    cutmix = {"alpha": 1.0, "prob": 0.5}
    try:
        constants.sensorium_dir = tmp_path
        with pytest.MonkeyPatch.context() as mp:
            mp.setenv("SENSORIUM_FOLD_ASSIGNMENT", "trial")
            mouse_data.get_folds_tiers.cache_clear()
            mice = [mouse_data.get_mouse_data(m, list(constants.folds_splits)) for m in constants.mice]
            dataset = TrainMiceDataset(mice, WindowIndexer(**frame_stack),
                                       get_inputs_processor("stack_inputs", {"size": (16, 16)}),
                                       get_responses_processor("identity", {}), mouse_epoch_size=8,
                                       mixer=CutMix(**cutmix), seed=21)
            loader = MiceDataLoader(dataset, batch_size=8, shuffle=True, seed=21, num_threads=2, drop_last=True)
            for epoch, count in ((0, 3), (2, 1)):  # set-up's first batches of epoch 0, and a later epoch
                loader.set_epoch(epoch)
                batches = iter(loader)
                for index in range(count):
                    got = next(batches)
                    expected = ref_data.train_batch(ref_data.Tree(tree), index, 21, epoch, 8, 80, 10, max(neurons),
                                                    frame_stack, (16, 16), cutmix)
                    for g, e in zip((got.inputs, got.targets, got.weights), expected):
                        np.testing.assert_allclose(g, e, rtol=1e-6, atol=1e-6)
                batches.close()
    finally:
        constants.sensorium_dir = saved
        mouse_data.get_folds_tiers.cache_clear()


@pytest.mark.parametrize("length", [7, 20, 40])
def test_whole_trial_prediction_matches_predictor(length):
    from sensorium_tpu_torch.infer.predictor import Predictor

    from benchmark.harness import synth

    params = {"frame_stack": {"size": 4, "step": 2, "position": "last"},
              "inputs_processor": ["stack_inputs", {"size": [16, 16], "pad_fill_value": 0.0}],
              "responses_processor": ["identity", {}]}
    predictor = Predictor.from_module(program_module(TOY_NN, 9), params, chunk_size=8, device="cpu")
    video, behavior, pupil = synth.trial_arrays(synth.Draws(9, "trials", CPU), (12, 16), length)
    got = predictor.predict_trial(video, behavior, pupil, mouse_index=4)
    expected = ref_data.predict_trial(make_weights(TOY_NN, 9, CPU), TOY_NN, video, behavior, pupil, 4,
                                      params["frame_stack"], (16, 16), CPU, chunk=8)
    np.testing.assert_allclose(got, expected, rtol=1e-5, atol=1e-5 * float(np.abs(expected).max()))


def test_fp8_control_rounds_every_stored_value():
    q = ref.Precision("fp8")
    x = torch.linspace(-3.0, 3.0, 1001, requires_grad=True)
    y = q(x)
    assert 0 < float((y - x).abs().max()) <= 3.0 / 448 * 32  # e4m3: 3 mantissa bits
    y.sum().backward()
    assert torch.all(x.grad == 1.0)
    assert ref.FLOAT32(x) is x
