"""The port's ``dryrun_multichip`` (``sensorium_tpu_torch/tools/dryrun.py``)
against the JAX repo's (``__graft_entry__.py``), on the CPU.

The mesh shape of both for the same device count and environment, and the
toy dry run itself over four gloo ranks (2 threads each), plain and with
``SENSORIUM_DRYRUN_SLICES=2``: each must print JAX's ``ok`` line with JAX's
mesh, after holding its sharded loss to rank 0's unsharded step within
1e-4 relative (the JAX toy's check). The step itself is held to JAX's: the
same global batch, and from the JAX toy's seed-0 weights the same sharded
loss.
"""

from __future__ import annotations

import re

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as graft
import sensorium_tpu.engine.steps as jax_steps
from sensorium_tpu.engine.model import MouseModel as JaxMouseModel
from sensorium_tpu_torch.tools import dryrun


def ok_mesh(out: str, n: int) -> str:
    """The ``mesh=...`` of the ``dryrun_multichip(n) ok`` line in ``out``."""
    match = re.search(rf"^dryrun_multichip\({n}\) ok: mesh=(\{{[^}}]*\}})", out, re.MULTILINE)
    assert match, out
    return match.group(1)


@pytest.mark.parametrize("n, env, expected", [
    (1, {}, {"data": 1, "model": 1}),
    (2, {}, {"data": 1, "model": 2}),
    (3, {}, {"data": 3, "model": 1}),
    (4, {}, {"data": 1, "model": 4}),
    (6, {}, {"data": 3, "model": 2}),
    (8, {}, {"data": 2, "model": 4}),
    (8, {"SENSORIUM_DRYRUN_SLICES": "2"}, {"replica": 2, "data": 2, "model": 2}),
    (4, {"SENSORIUM_DRYRUN_SLICES": "2"}, {"replica": 2, "data": 1, "model": 2}),
    (8, {"SENSORIUM_DRYRUN_MODEL": "2"}, {"data": 4, "model": 2}),
    (8, {"SENSORIUM_DRYRUN_SLICES": "2", "SENSORIUM_DRYRUN_MODEL": "4"}, {"replica": 2, "data": 1, "model": 4}),
    (8, {"SENSORIUM_DRYRUN_MODEL": "3"}, "does not divide 8"),
    (6, {"SENSORIUM_DRYRUN_SLICES": "4"}, "do not factor into slices=4 x model=2"),
])
def test_mesh_shape_is_the_jax_rule(n, env, expected):
    """``__graft_entry__.py``'s rule, case by case, with its errors."""
    if isinstance(expected, str):
        with pytest.raises(ValueError, match=re.escape(expected)):
            dryrun.mesh_shape(n, env)
        return
    assert dryrun.mesh_shape(n, env) == expected


def test_the_toy_is_the_jax_toy():
    assert dryrun.TOY_NN == graft._TOY_NN_KWARGS
    params, frames, image = dryrun.dryrun_params(flagship=False)
    assert params["nn_module"] == ("dwiseneuro", graft._TOY_NN_KWARGS)
    assert (frames, image) == (4, (16, 16))


def test_flagship_geometry_is_cut_as_jax_cuts_it(monkeypatch):
    params, frames, image = dryrun.dryrun_params(flagship=True, env={})
    assert (frames, image) == (4, (16, 16)) and params["inputs_processor"][1]["size"] == (16, 16)
    assert params["nn_module"][1]["cortex_features"] == (1024, 2048, 4096)
    full = dryrun.dryrun_params(flagship=True, env={"SENSORIUM_DRYRUN_FULL": "1"})
    assert full[1:] == (16, (64, 64))


@pytest.mark.parametrize("slices", [None, "2"])
def test_toy_dryrun_over_four_gloo_ranks_matches_jax(slices, monkeypatch, capsys):
    """``dryrun_multichip(4, flagship=False, device="cpu")`` prints the ``ok``
    line with the mesh that JAX's dry run picks for 4 devices in the same
    environment (the test suite's 8 virtual CPU devices)."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    if slices:
        monkeypatch.setenv("SENSORIUM_DRYRUN_SLICES", slices)
    graft.dryrun_multichip(4, flagship=False)
    jax_mesh = ok_mesh(capsys.readouterr().out, 4)
    result = dryrun.dryrun_multichip(4, flagship=False, device="cpu")
    out = capsys.readouterr().out
    assert ok_mesh(out, 4) == jax_mesh == str(result["mesh"])
    assert ("'replica': 2" in jax_mesh) == bool(slices)
    assert abs(result["loss"] - result["unsharded_loss"]) <= dryrun.LOSS_RTOL * abs(result["unsharded_loss"])
    assert len(result["launches_by_rank"]) == 4


def test_toy_step_is_the_jax_step(monkeypatch, tmp_path, capsys):
    """JAX's toy dry run over 4 devices, its sharded step recorded: its
    global batch is ``global_batch``'s array for array, and the port's dry
    run over four gloo ranks, started from the same weights (the JAX toy's
    ``build_state(seed=0)``, written as a checkpoint), gives its sharded
    loss within the dry run's 1e-4. The drop rates are 0 on both sides: the
    two stacks draw their dropout masks from different generators."""
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    no_drop = {**graft._TOY_NN_KWARGS, "drop_rate": 0.0, "drop_path_rate": 0.0}
    monkeypatch.setattr(graft, "_TOY_NN_KWARGS", no_drop)
    monkeypatch.setattr(dryrun, "TOY_NN", no_drop)
    recorded = {}
    make_train_step = jax_steps.make_train_step

    def recording(*args, mesh=None, **kwargs):
        step = make_train_step(*args, mesh=mesh, **kwargs)

        def sharded_step(state, *batch):
            # Fetched before the step, which donates the state's buffers.
            recorded.update(params=jax.device_get(state.params), batch=[np.asarray(jax.device_get(a)) for a in batch])
            new_state, loss = step(state, *batch)
            recorded["loss"] = float(loss)
            return new_state, loss

        return step if mesh is None else sharded_step

    monkeypatch.setattr(jax_steps, "make_train_step", recording)
    # In this process (the suite's 8 virtual CPU devices): the public entry
    # would re-exec into a subprocess, where nothing is recorded.
    graft._dryrun_multichip_impl(4, flagship=False)
    params, frames, image = dryrun.dryrun_params(flagship=False)
    batch = dryrun.global_batch(params, len(recorded["batch"][0]), frames, image)
    for got, want in zip((batch.inputs, batch.targets, batch.weights), recorded["batch"]):
        np.testing.assert_array_equal(got, want)

    init = JaxMouseModel(params)
    init.set_ema(0.999)
    init.build_state(seed=0, learning_rate=1e-3)
    for got, want in zip(jax.tree_util.tree_leaves(init.state.params), jax.tree_util.tree_leaves(recorded["params"])):
        np.testing.assert_array_equal(np.asarray(got), want)
    init.save(tmp_path / "toy.ckpt")
    capsys.readouterr()
    result = dryrun.dryrun_multichip(4, flagship=False, device="cpu", init=tmp_path / "toy.ckpt")
    assert abs(result["loss"] - recorded["loss"]) <= dryrun.LOSS_RTOL * abs(recorded["loss"]), (result, recorded)


def test_fewer_cards_than_ranks_raise():
    """Without ``device="cpu"`` the ranks take one card each: this host's
    cards are counted first (none here)."""
    if torch.cuda.is_available():
        pytest.skip("counts the cards of a host without one")
    with pytest.raises(RuntimeError, match=r"needs 2 cards, one a rank; 0 visible"):
        dryrun.dryrun_multichip(2, flagship=False)
    with pytest.raises(ValueError, match="'cuda' or 'cpu'"):
        dryrun.dryrun_multichip(2, flagship=False, device="tpu")
