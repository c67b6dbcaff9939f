"""The port's data parallelism (``sensorium_tpu_torch/parallel``) against one
process and against the JAX package's data mesh, on the CPU.

Two ranks of a gloo group (``tests/torch_mesh_worker.py``, 2 threads each)
run every scenario of ``run_scenarios`` over ``create_mesh()`` once; this
process runs the same scenarios without a mesh. The weights are the JAX
package's ``build_state(seed=0)`` of ``tests/test_engine.py``'s tiny model
(SGD, drop rates 0 unless a case turns them on), moved across with
``from_jax_variables``, and the JAX reference is its
``MouseModel(mesh=create_mesh(num_data=2))`` step on the same batch. The
tolerances are ``tests/test_parallel.py``'s: the loss within 1e-5
relative, every weight within rtol 1e-4 / atol 1e-5, the depthwise kernels
within atol 5e-4 (cancellation in their gradients), BN statistics within
rtol 1e-4 / atol 1e-5.
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from sensorium_tpu.data.datasets import MiceBatch as JaxMiceBatch
from sensorium_tpu.engine.model import MouseModel as JaxMouseModel
from sensorium_tpu.parallel import mesh as jax_mesh
from sensorium_tpu_torch.compat import from_jax_variables
from sensorium_tpu_torch.data.datasets import MiceBatch
from sensorium_tpu_torch.data.loader import MiceDataLoader
from sensorium_tpu_torch.engine.model import MouseModel, load_model
from sensorium_tpu_torch.infer.predictor import Predictor
from sensorium_tpu_torch.parallel import mesh as mesh_lib
from tests import torch_mesh_worker as worker
from tests.test_engine import tiny_params as jax_tiny_params

REPO = Path(__file__).resolve().parents[1]
WORLD = 2
WORKER_TIMEOUT = 300  # seconds; the two ranks take ~7
LOSS_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL, DW_ATOL = 1e-4, 1e-5, 5e-4
STATS_RTOL, STATS_ATOL = 1e-4, 1e-5
JAX_PREDICTOR_TOL = 1e-4  # the port's Predictor against the JAX package's (tests/test_torch_predictor.py)


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def random_batch(rng, batch: int) -> dict:
    inputs = rng.uniform(0, 255, (batch, 5, 4, 16, 16)).astype(np.float32)
    targets = rng.uniform(0, 2, (batch, 7, 4)).astype(np.float32)
    weights = np.zeros((batch, 2), np.float32)
    weights[np.arange(batch), rng.integers(0, 2, batch)] = 1.0
    return {"inputs": inputs, "targets": targets, "weights": weights}


def jax_step(batch: dict, lr: float):
    """The JAX package's data=2 mesh step from seed 0: (variables before, loss, variables after)."""
    model = JaxMouseModel(worker.tiny_params(), mesh=jax_mesh.create_mesh(num_data=WORLD))
    model.build_state(seed=0, learning_rate=lr)
    before = from_jax_variables(jax.device_get(model.state.params), jax.device_get(model.state.batch_stats))
    loss = float(model.train_step(JaxMiceBatch(**batch)))
    after = from_jax_variables(jax.device_get(model.state.params), jax.device_get(model.state.batch_stats))
    return before, loss, {k: v.numpy() for k, v in after.items()}


def run_ranks(job: Path) -> list[dict]:
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "2"}
    port = free_port()
    procs = [subprocess.Popen([sys.executable, "-m", "tests.torch_mesh_worker", str(job), str(rank), str(WORLD),
                               str(port)], cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for rank in range(WORLD)]
    outputs = [proc.communicate(timeout=WORKER_TIMEOUT)[0] for proc in procs]
    for rank, (proc, out) in enumerate(zip(procs, outputs)):
        assert proc.returncode == 0, f"rank {rank}:\n{out}"
    return [dict(np.load(job / f"rank{rank}.npz")) for rank in range(WORLD)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(single, ranks, jax)``: the scenarios in one process, on each rank,
    and the JAX package's sgd and hetero steps."""
    job = tmp_path_factory.mktemp("mesh_job")
    rng = np.random.default_rng(0)
    batches = {"batch8": random_batch(rng, 8), "hetero8": random_batch(rng, 8), "batch5": random_batch(rng, 5),
               "batch6": random_batch(rng, 6)}
    batches["hetero8"]["inputs"][:4] *= 3.0  # the two ranks' halves differ
    weights, jax_loss, jax_sgd = jax_step(batches["batch8"], worker.LR)
    _, _, jax_hetero = jax_step(batches["hetero8"], 0.0)
    inputs = {f"w/{name}": value.numpy() for name, value in weights.items()}
    inputs.update({f"{name}/{key}": value for name, batch in batches.items() for key, value in batch.items()})
    inputs["seed_by_rank"] = np.array([0, 5])
    np.savez(job / "inputs.npz", **inputs)
    ranks = run_ranks(job)
    single = worker.run_scenarios(None, dict(np.load(job / "inputs.npz")))
    return single, ranks, {"sgd/loss": jax_loss, "sgd": jax_sgd, "hetero": jax_hetero}


def states(out: dict, label: str) -> dict:
    prefix = f"{label}/state/"
    return {key[len(prefix):]: value for key, value in out.items() if key.startswith(prefix)}


def assert_weights_close(got: dict, expected: dict, label: str) -> None:
    assert set(got) == set(expected), label
    for name, value in expected.items():
        if name.endswith((".mean", ".var")):
            np.testing.assert_allclose(got[name], value, rtol=STATS_RTOL, atol=STATS_ATOL, err_msg=f"{label} {name}")
        elif "dw_kernel" in name:
            np.testing.assert_allclose(got[name], value, atol=DW_ATOL, err_msg=f"{label} {name}")
        else:
            np.testing.assert_allclose(got[name], value, rtol=PARAM_RTOL, atol=PARAM_ATOL, err_msg=f"{label} {name}")


def test_worker_model_is_the_jax_tests_tiny_model():
    expected = jax_tiny_params()
    got = worker.tiny_params(drop=True)
    assert got["nn_module"] == expected["nn_module"]
    for key in ("loss", "frame_stack", "inputs_processor", "responses_processor", "iter_size"):
        assert got[key] == expected[key]


@pytest.mark.parametrize("case", [
    ("mesh", {"num_model": 3}, "does not fit"),
    ("mesh", {"num_data": 16, "num_model": 2}, "does not fit"),
    ("mesh", {"num_data": 4}, {"data": 4, "model": 1}),
    ("mesh", {}, {"data": 8, "model": 1}),
    ("hybrid", {"num_slices": 3}, "do not factor"),
    ("hybrid", {"num_slices": 2, "num_data": 3}, "covers 6 devices but 8"),
    ("hybrid", {"num_slices": 2}, {"replica": 2, "data": 4, "model": 1}),
])
def test_mesh_factoring_matches_jax(case):
    """``tests/test_parallel.py`` TestMeshFactoring, over 8 devices on both
    sides: an auto mesh must cover every device, an explicit smaller one is
    a subset, a larger one is an error; the axes are JAX's, ``model`` too."""
    kind, kwargs, expected = case
    port_fn = mesh_lib.create_mesh if kind == "mesh" else mesh_lib.create_hybrid_mesh
    jax_fn = jax_mesh.create_mesh if kind == "mesh" else jax_mesh.create_hybrid_mesh
    devices = ["cpu"] * 8
    if isinstance(expected, str):
        for fn, extra in ((port_fn, {"devices": devices}), (jax_fn, {})):
            with pytest.raises(ValueError, match=expected):
                fn(**kwargs, **extra)
        return
    mesh = port_fn(**kwargs, devices=devices)
    assert mesh.shape == expected == dict(jax_fn(**kwargs).shape)
    assert len(mesh.devices) == mesh_lib.data_extent(mesh) and mesh.processes == 1 and not mesh.distributed
    assert mesh_lib.data_axes(mesh) == tuple(axis for axis in expected if axis != "model")


@pytest.mark.parametrize("fn", [mesh_lib.create_mesh, mesh_lib.create_hybrid_mesh])
def test_a_model_axis_is_refused(fn):
    """A model axis over one process's devices is accepted for serving, in
    JAX's device order (model groups of adjacent devices), and refused for
    training, which takes one card a process and names the path that does;
    over a process group of 4 (a fake one: the groups, no collective) it is
    accepted in JAX's device order, with each rank's data and model groups."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    import torch.distributed as dist

    kwargs = {"num_slices": 2} if fn is mesh_lib.create_hybrid_mesh else {}
    local = fn(num_model=2, devices=[f"cpu:{i}" for i in range(8)], **kwargs)
    assert local.shape == ({"replica": 2, "data": 2, "model": 2} if kwargs else {"data": 4, "model": 2})
    assert not local.distributed and mesh_lib.data_extent(local) == 4 and mesh_lib.tensor_parallel(local)
    groups = mesh_lib.model_groups(local)
    assert [[d.index for d in group.devices] for group in groups] == [[0, 1], [2, 3], [4, 5], [6, 7]]
    assert all(group.shape == {"model": 2} and mesh_lib.data_extent(group) == 1 for group in groups)
    with pytest.raises(ValueError, match="cli.train --mesh data or --mesh data,model"):
        MouseModel(worker.tiny_params(), mesh=local)
    expected = {"replica": 2, "data": 1, "model": 2} if kwargs else {"data": 2, "model": 2}
    for rank in range(4):
        dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=4)
        try:
            mesh = fn(num_model=2, **kwargs)
            assert mesh.shape == expected and mesh_lib.data_extent(mesh) == 2 and mesh_lib.tensor_parallel(mesh)
            assert (mesh.index, mesh.data_index, mesh.model_index) == (rank, rank // 2, rank % 2)
            assert dist.get_process_group_ranks(mesh.data_group) == [rank % 2, rank % 2 + 2]
            assert dist.get_process_group_ranks(mesh.model_group) == [rank // 2 * 2, rank // 2 * 2 + 1]
            with pytest.raises(ValueError, match="one process's devices"):
                mesh_lib.model_groups(mesh)
        finally:
            dist.destroy_process_group()


def test_shard_batch_rows_and_scalars():
    batch = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    mesh = mesh_lib.Mesh({"data": 2}, (torch.device("cpu"),), 1, 2)
    rows, scalar, python_scalar = mesh_lib.shard_batch(mesh, batch, np.float32(0.5), 0.5)
    np.testing.assert_array_equal(rows, batch[8:])
    assert python_scalar == 0.5
    assert scalar == 0.5 and np.ndim(scalar) == 0
    assert mesh_lib.shard_batch(None, batch)[0] is batch
    # Each microbatch's slice: microbatch i holds the rows it holds without a mesh.
    np.testing.assert_array_equal(mesh_lib.shard_batch(mesh, batch, chunks=2)[0], batch[np.r_[4:8, 12:16]])
    # Evaluation pads with zero rows.
    padded = mesh_lib.shard_batch(mesh, batch[:5], pad=True)[0]
    np.testing.assert_array_equal(padded, np.concatenate([batch[3:5], np.zeros((1, 3), np.float32)]))
    with pytest.raises(ValueError, match="batch_size 6 / iter_size 2"):
        mesh_lib.shard_rows(6, 0, 2, chunks=2)


def test_two_rank_step_matches_one_process_and_jax(runs):
    """The acceptance case: loss, every weight and BN statistic after one
    SGD step over two ranks, against the port in one process and against
    the JAX package's data=2 mesh step from the same weights."""
    single, ranks, jax_ref = runs
    for out in ranks:
        assert out["sgd/loss"] == pytest.approx(float(single["sgd/loss"]), rel=LOSS_RTOL)
        assert out["sgd/loss"] == pytest.approx(jax_ref["sgd/loss"], rel=LOSS_RTOL)
        assert_weights_close(states(out, "sgd"), states(single, "sgd"), "vs one process:")
        assert_weights_close(states(out, "sgd"), jax_ref["sgd"], "vs jax:")


def test_bn_statistics_see_the_global_batch(runs):
    """``tests/test_parallel.py`` test_bn_stats_see_global_batch: the
    ranks' halves differ by 3x, and the running statistics are still the
    global batch's."""
    single, ranks, jax_ref = runs
    stats = {k: v for k, v in states(single, "hetero").items() if k.endswith((".mean", ".var"))}
    for out in ranks:
        got = states(out, "hetero")
        for name, value in stats.items():
            np.testing.assert_allclose(got[name], value, rtol=STATS_RTOL, atol=STATS_ATOL, err_msg=name)
            np.testing.assert_allclose(got[name], jax_ref["hetero"][name], rtol=STATS_RTOL, atol=STATS_ATOL,
                                       err_msg=name)


def test_depthwise_weight_gradients_are_not_multiplied_by_the_extent(runs):
    """Each rank returns its local dw (and BN) gradients; the step sums them
    once: the sharded depthwise weight gradients are the one-process ones,
    not twice them (the JAX package's ``ops/conv.py`` dw custom VJP guards
    the same property)."""
    single, ranks, _ = runs
    names = [k for k in single if k.startswith("sgd/grad/") and "dw_kernel" in k]
    assert any("spatial_dw_kernel" in k for k in names) and any("temporal_dw_kernel" in k for k in names)
    for out in ranks:
        for name in names:
            expected = single[name]
            scale = float(np.abs(expected).max())
            np.testing.assert_allclose(out[name], expected, rtol=1e-4, atol=1e-5 * scale, err_msg=name)


@pytest.mark.parametrize("label", ["iter2", "distill", "dropout"])
def test_microbatches_distillation_and_dropout_match_one_process(runs, label):
    """``iter_size=2`` (each rank's slice of each microbatch), a distillation
    step (the filled cells' count and weight sum are global), and a step with
    the drop rates on (masks drawn for the global batch, cut to the rank's rows)."""
    single, ranks, _ = runs
    for out in ranks:
        assert out[f"{label}/loss"] == pytest.approx(float(single[f"{label}/loss"]), rel=LOSS_RTOL)
        assert_weights_close(states(out, label), states(single, label), f"{label}:")


def test_ragged_val_batch_is_padded_and_exact(runs):
    """5 rows over 2 ranks: padded to 6 with zero-weight rows; the loss, the
    predictions of the real rows and the metric sums are the one-process ones."""
    single, ranks, _ = runs
    prediction = np.concatenate([out["ragged_val/prediction"] for out in ranks], axis=1)
    assert prediction.shape[1] == 6
    np.testing.assert_allclose(prediction[:, :5], single["ragged_val/prediction"], rtol=1e-4, atol=1e-5)
    for out in ranks:
        assert out["ragged_val/loss"] == pytest.approx(float(single["ragged_val/loss"]), rel=LOSS_RTOL)
        np.testing.assert_allclose(out["ragged_val/counts"], single["ragged_val/counts"])
        np.testing.assert_allclose(out["ragged_val/sums"], single["ragged_val/sums"], rtol=1e-4, atol=1e-3)


def test_ragged_train_batch_and_uneven_microbatches_are_rejected(runs):
    single, ranks, _ = runs
    assert str(single["ragged_train/error"]) == "" and str(single["uneven_microbatches/error"]) == ""
    for out in ranks:
        assert "drop_last" in str(out["ragged_train/error"])
        assert "3 rows (batch_size 6 / iter_size 2)" in str(out["uneven_microbatches/error"])
        assert "data extent 2" in str(out["uneven_microbatches/error"])


def test_ranks_hold_identical_replicas(runs):
    """Every record of rank 1 is rank 0's bit for bit: the reduced gradients,
    statistics and updates are the same on both; and a model built from
    another seed on rank 1 holds rank 0's weights after the broadcast."""
    _, (rank0, rank1), _ = runs
    assert rank0["mesh/shape"].tolist() == [2, 0, 2] and rank1["mesh/shape"].tolist() == [2, 1, 2]
    shared = [k for k in rank0 if not k.startswith(("ragged_val/prediction", "mesh/"))]
    for key in shared:
        np.testing.assert_array_equal(rank0[key], rank1[key], err_msg=key)
    assert any(k.startswith("broadcast/state/") for k in shared)


class RowDataset:
    """Rows whose values say which (index, epoch) filled them."""

    row_shapes = ((2, 3), (4,))
    num_mice = 3

    def __len__(self) -> int:
        return 11

    def fill_into(self, index: int, epoch: int, input_out, target_out) -> int:
        input_out[...] = index + 100 * epoch
        target_out[...] = -index
        return index % self.num_mice


@pytest.mark.parametrize("shuffle, drop_last, microbatches", [(True, True, 2), (False, False, 1)])
def test_sharded_loader_fills_the_global_batches_rows(shuffle, drop_last, microbatches):
    """Shard i of 2 of each batch is the unsharded batch's rows, bit for
    bit; a short last batch is padded with zero-weight zero rows."""
    dataset = RowDataset()

    def batches(shard):
        loader = MiceDataLoader(dataset, batch_size=4, shuffle=shuffle, seed=3, num_threads=2, drop_last=drop_last,
                                shard=shard, microbatches=microbatches)
        loader.set_epoch(2)
        return list(loader)

    full = batches(None)
    for index in range(WORLD):
        mesh = mesh_lib.Mesh({"data": WORLD}, (torch.device("cpu"),), index, WORLD)
        got = batches((index, WORLD))
        assert len(got) == len(full)
        for batch, whole in zip(got, full):
            expected = mesh_lib.shard_batch(mesh, whole.inputs, whole.targets, whole.weights, chunks=microbatches,
                                            pad=not drop_last)
            for array, want in zip((batch.inputs, batch.targets, batch.weights), expected):
                np.testing.assert_array_equal(array, want)
    if not drop_last:  # 11 rows: the last batch has 3, padded to 4; shard 1 holds rows 2 and 3
        assert full[-1].inputs.shape[0] == 3 and got[-1].inputs.shape[0] == 2
        assert got[-1].weights[1].sum() == 0.0 and not got[-1].inputs[1].any() and got[-1].weights[0].sum() == 1.0


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    path = tmp_path_factory.mktemp("predictor") / "model-000-0.100000.ckpt"
    model = MouseModel(worker.tiny_params(), device="cpu")
    model.build_state(seed=0, learning_rate=0.0)
    model.save(path)
    return path


def test_predictor_over_two_cpu_replicas_matches_one(checkpoint):
    """Each chunk's windows split over two replicas (the last chunk short),
    the predictions gathered for the blend: the one-replica trial."""
    rng = np.random.default_rng(1)
    video = rng.uniform(0, 255, (12, 14, 23)).astype(np.float32)
    behavior, pupil = rng.normal(size=(2, 23)).astype(np.float32), rng.normal(size=(2, 23)).astype(np.float32)
    one = Predictor(checkpoint, chunk_size=4, device="cpu")
    two = Predictor(checkpoint, chunk_size=4, mesh=mesh_lib.create_mesh(devices=["cpu", "cpu"]))
    assert len(two.replicas) == 2 and two.replicas[1][0] is not two.model
    for mouse in (0, 1):
        expected = one.predict_trial(video, behavior, pupil, mouse)
        got = two.predict_trial(video, behavior, pupil, mouse)
        np.testing.assert_allclose(got, expected, rtol=1e-5, atol=1e-5 * np.abs(expected).max())


def test_predictor_mesh_refusals(checkpoint):
    with pytest.raises(ValueError, match="multiple of the mesh"):
        Predictor(checkpoint, chunk_size=3, mesh=mesh_lib.create_mesh(devices=["cpu", "cpu"]))
    across = mesh_lib.Mesh({"data": 2}, (torch.device("cpu"),), 0, 2, group=object())
    with pytest.raises(ValueError, match="single process"):
        Predictor(checkpoint, chunk_size=4, mesh=across)


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """The JAX tests' tiny model from seed 0 (``tests/test_parallel.py``
    TestShardedPredictor), saved by the JAX engine."""
    model = JaxMouseModel(jax_tiny_params())
    model.build_state(seed=0, learning_rate=1e-3)
    path = tmp_path_factory.mktemp("jax_predictor") / "model-001-0.100000.ckpt"
    model.save(path)
    return path


def jax_test_trial(seed: int) -> tuple:
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 255, (12, 16, 24)).astype(np.float32), rng.uniform(0, 5, (2, 24)).astype(np.float32),
            rng.uniform(50, 200, (2, 24)).astype(np.float32))


MODEL_MESHES = {
    "data4_model2": (lambda devices: mesh_lib.create_mesh(num_model=2, devices=devices),
                     lambda: jax_mesh.create_mesh(num_data=4, num_model=2), 4),
    "hybrid2x2x2": (lambda devices: mesh_lib.create_hybrid_mesh(num_slices=2, num_data=2, num_model=2,
                                                                devices=devices),
                    lambda: jax_mesh.create_hybrid_mesh(num_slices=2, num_data=2, num_model=2), 41),
}


@pytest.mark.parametrize("layout", sorted(MODEL_MESHES))
def test_predictor_over_a_model_axis_matches_jax_and_one_device(jax_checkpoint, layout):
    """``tests/test_parallel.py`` TestShardedPredictor (a (data 4, model 2)
    mesh) and test_hybrid_predictor_shards_chunks_across_replica (a (2, 2, 2)
    mesh) on 8 CPU devices: one replica a data index, its cortex and readout
    sliced over its model group; the trial within JAX's rtol 1e-5 / atol 1e-6
    of the one-device port Predictor, and of JAX's Predictor on the same
    mesh at the port's tolerance against the JAX package (rtol 1e-4 / atol
    1e-4, ``tests/test_torch_predictor.py``: the two fp32 forwards sum in
    other orders, sharded or not). A chunk that does not divide over
    replica x data raises."""
    from sensorium_tpu.infer.predictor import Predictor as JaxPredictor

    port_mesh, jax_mesh_fn, seed = MODEL_MESHES[layout]
    mesh = port_mesh(["cpu"] * 8)
    trial = jax_test_trial(seed)
    one = Predictor(jax_checkpoint, chunk_size=8, device="cpu").predict_trial(*trial, mouse_index=1)
    sharded = Predictor(jax_checkpoint, chunk_size=8, mesh=mesh)
    assert len(sharded.replicas) == mesh_lib.data_extent(mesh) == 4
    got = sharded.predict_trial(*trial, mouse_index=1)
    want = JaxPredictor(jax_checkpoint, chunk_size=8, mesh=jax_mesh_fn()).predict_trial(*trial, mouse_index=1)
    np.testing.assert_allclose(got, one, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, want, rtol=JAX_PREDICTOR_TOL, atol=JAX_PREDICTOR_TOL)
    with pytest.raises(ValueError, match="batch-sharding ways"):
        Predictor(jax_checkpoint, chunk_size=6, mesh=mesh)


def test_each_replica_holds_one_slice_of_each_sharded_weight_a_card(jax_checkpoint):
    """Over (data 2, model 2): each replica's readout and cortex kernels are
    ``LocalSlices`` of two slices, each 1/2 of the whole weight's bytes on its
    group's card k, gathered back to the checkpoint's tensors under the JAX
    tree's names; the replicated weights stay whole on the group's first card."""
    from sensorium_tpu_torch.parallel import tensor as tensor_lib

    whole = load_model(jax_checkpoint, device="cpu").state.eval_model.state_dict()
    mesh = mesh_lib.create_mesh(num_model=2, devices=["cpu"] * 4)
    sharded = Predictor(jax_checkpoint, chunk_size=4, mesh=mesh)
    sliced = {"readout_kernel": 3, "readout_bias": 2, "cortex_0.kernel": 2, "cortex_1.kernel": 2}
    for (module, device), group in zip(sharded.replicas, mesh_lib.model_groups(mesh)):
        assert device == group.device
        for name, axis in sliced.items():
            slices = module.get_submodule(name)
            assert isinstance(slices, tensor_lib.LocalSlices) and slices.axis == axis
            assert [piece.device for piece in slices] == list(group.devices)
            for k, piece in enumerate(slices):
                assert piece.numel() * piece.element_size() * 2 == whole[name].numel() * whole[name].element_size()
                torch.testing.assert_close(piece, whole[name].chunk(2, axis)[k], rtol=0, atol=0)
        gathered = tensor_lib.gather_state_dict(module, None)
        assert set(gathered) == set(whole)
        for name, value in whole.items():
            assert torch.equal(gathered[name], value), name


def test_load_model_over_one_process_cards_refuses(jax_checkpoint):
    """``load_model(mesh=)`` takes a process group's mesh (one device a
    process); a mesh of several of this process's devices serves through
    ``Predictor(mesh=)``, which the refusal names."""
    with pytest.raises(ValueError, match=r"serves through Predictor\(mesh=\)"):
        load_model(jax_checkpoint, mesh=mesh_lib.create_mesh(num_model=2, devices=["cpu"] * 4))


def test_a_training_mesh_holds_one_device_a_process():
    with pytest.raises(ValueError, match="one device a process"):
        MouseModel(worker.tiny_params(), mesh=mesh_lib.create_mesh(devices=["cpu", "cpu"]))


def test_no_mesh_leaves_batches_and_losses_alone():
    """``mesh=None`` everywhere is the single-process path: the global batch
    passes unsharded and nothing is reduced."""
    batch = random_batch(np.random.default_rng(2), 4)
    model = MouseModel(worker.tiny_params(), device="cpu")
    assert model._shard(MiceBatch(**batch), train=True).inputs is batch["inputs"]
    loss = torch.tensor(3.0)
    assert mesh_lib.all_reduce(None, loss) is loss and float(loss) == 3.0
    assert mesh_lib.current() is None and mesh_lib.row_shard() is None


@pytest.fixture
def group_of_one():
    """A gloo group of this process alone: every collective of the mesh path
    runs, and a sum over one process changes nothing."""
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{free_port()}", world_size=1, rank=0)
    try:
        yield mesh_lib.create_mesh()
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_bn_function_over_a_group_of_one_is_bitwise_the_function_without_a_mesh(group_of_one, dtype):
    from sensorium_tpu_torch.ops.norm import batch_norm_train

    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.normal(40, 7, (4, 3, 6, 5, 24))).to(dtype)
    scale, bias, shift = (torch.from_numpy(rng.normal(m, 1, 24)).to(dtype) for m in (1, 0, 38))
    dy = torch.from_numpy(rng.normal(size=x.shape)).to(dtype)
    results = []
    for mesh in (None, group_of_one):
        leaves = [t.clone().requires_grad_(True) for t in (x, scale, bias)]
        y, mean, var = batch_norm_train(*leaves, shift, 1e-5, dtype, mesh)
        y.backward(dy)
        results.append([y, mean, var] + [t.grad for t in leaves])
    for without, over in zip(*results):
        assert torch.equal(without, over)


def test_train_step_over_a_group_of_one_is_bitwise_the_single_process_step(group_of_one):
    """Drop rates on, EMA, AdamW, two microbatches: the mesh path at world size
    one (the cost ``--multihost ADDR,1,0`` measures on one card) computes the
    single-process step bit for bit."""
    params = {**worker.tiny_params(drop=True, iter_size=2), "optimizer": ("AdamW", {"lr": 1e-3, "weight_decay": 0.05})}
    batch = MiceBatch(**random_batch(np.random.default_rng(4), 8))
    runs = []
    for mesh in (None, group_of_one):
        model = MouseModel(params, device="cpu", mesh=mesh)
        model.set_ema(0.9)
        model.build_state(seed=0, learning_rate=1e-3)
        losses = [float(model.train_step(batch)) for _ in range(2)]
        val = model.val_step(batch)
        runs.append((losses, float(val[0]), model.state.model.state_dict(), model.state.ema_model.state_dict()))
    (losses, val_loss, live, ema), (mesh_losses, mesh_val_loss, mesh_live, mesh_ema) = runs
    assert losses == mesh_losses and val_loss == mesh_val_loss
    for name in live:
        assert torch.equal(live[name], mesh_live[name]), name
        assert torch.equal(ema[name], mesh_ema[name]), name


class SignallingLoader:
    """Batches that latch the preemption signal as batch ``at`` is handed over."""

    def __init__(self, batches, preemption, at: int):
        self.batches, self.preemption, self.at = batches, preemption, at
        self.handed = 0

    def __iter__(self):
        for i, batch in enumerate(self.batches):
            if i == self.at:
                self.preemption.triggered = True
            self.handed += 1
            yield batch


@pytest.mark.parametrize("mesh_path, steps", [(False, 2), (True, 3)])
def test_preemption_acts_one_step_late_over_a_process_group(group_of_one, tmp_path, mesh_path, steps):
    """Without a mesh the signal latched before step 2 ends the fit after it;
    over a process group the processes read the flag reduced after the
    previous step (no wait for the current one), so they act one step later,
    all at the same step, and the saved state resumes."""
    from sensorium_tpu_torch.engine.preemption import PreemptionHandler, TrainingPreempted

    batch = MiceBatch(**random_batch(np.random.default_rng(5), 4))
    model = MouseModel(worker.tiny_params(), device="cpu", mesh=group_of_one if mesh_path else None)
    model.build_state(seed=0, learning_rate=1e-3)
    preemption = PreemptionHandler(signals=())
    loader = SignallingLoader([batch] * 5, preemption, at=1)
    with pytest.raises(TrainingPreempted):
        model.fit(loader, num_epochs=1, preemption=preemption, preemption_save_path=tmp_path / "state.ckpt")
    assert loader.handed == steps and model.state.step == steps
    resumed = MouseModel(worker.tiny_params(), device="cpu")
    resumed.build_state(seed=1, learning_rate=1e-3)
    assert resumed.load_train_state(tmp_path / "state.ckpt")["epoch"] == -1 and resumed.state.step == steps
