"""The port's tensor parallelism (``parallel/tensor.py``) and its sharded
train state against one process and against the JAX package, on the CPU.

Four layouts of gloo ranks from ``tests/torch_mesh_worker.py`` (2 threads
each) run ``run_tp_scenarios`` once: ``{data: 2, model: 2}`` (4 ranks),
``{data: 1, model: 2}`` (2 ranks), ``{replica: 2, data: 1, model: 2}``
(4 ranks) and ``{data: 1, model: 4}`` (4 ranks; the tiny widths divide by
4); this process runs the same scenarios without a mesh. Every case
starts from one checkpoint of the JAX package's tiny model
(``tests/test_engine.py``, ``build_state(seed=0)``) through
``init_from_checkpoint``. The JAX references are its ``MouseModel`` steps
over ``create_mesh(num_data=2, num_model=2)``, ``create_mesh(num_data=1,
num_model=4)`` and ``create_hybrid_mesh(num_slices=2, num_data=1,
num_model=2)`` on 4 of the 8 CPU devices, with
SGD (momentum 0.9) and an EMA of 0.9 over the same two batches. The
tolerances are ``tests/test_parallel.py::
test_tp_train_step_matches_single_device_numerics``': the loss 1e-5
relative; weights and EMA rtol 1e-4 / atol 1e-4 (the depthwise kernels
atol 5e-4); BN statistics 1e-3 / 1e-3; the momentum 5e-2 / 2e-2 (its
depthwise kernels atol 5e-3). Last, two ``cli.train --multihost
127.0.0.1:PORT,2,ID --device cpu --mesh data,model --sharded-checkpoint``
processes train a fold against one process's logs and resume from their
``train_state.orbax``.
"""

from __future__ import annotations

import os
import shutil
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
from sensorium_tpu_torch.engine.model import MouseModel, load_model
from tests import torch_mesh_worker as worker
from tests.synthetic import build_synthetic_dataset, tiny_experiment_config
from tests.test_torch_multihost import LOSS_RTOL as LOG_LOSS_RTOL
from tests.test_torch_multihost import CORR_ATOL, data_dir, finish, read_records, start
from tests.test_torch_parallel import free_port, random_batch

REPO = Path(__file__).resolve().parents[1]
WORKER_TIMEOUT = 300  # seconds; a layout takes ~15
LOSS_RTOL = 1e-5
PARAM_RTOL, PARAM_ATOL, DW_ATOL = 1e-4, 1e-4, 5e-4
STATS_RTOL, STATS_ATOL = 1e-3, 1e-3
MOMENTUM_RTOL, MOMENTUM_ATOL, MOMENTUM_DW_ATOL = 5e-2, 2e-2, 5e-3
PREDICT_RTOL, PREDICT_ATOL = 1e-4, 1e-5
# layout -> (world, num_model, num_slices or "", the JAX mesh it is held to)
LAYOUTS = {
    "d2m2": (4, 2, "", "mesh"),
    "d1m2": (2, 2, "", "mesh"),
    "hybrid": (4, 2, "2", "hybrid"),
    "d1m4": (4, 4, "", "mesh4"),
}
LABELS = {"d2m2": "data2_model2", "d1m2": "data1_model2", "hybrid": "replica2_data1_model2",
          "d1m4": "data1_model4"}


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def jax_meshes() -> dict:
    devices = jax.devices()[:4]
    return {"mesh": jax_mesh.create_mesh(num_data=2, num_model=2, devices=devices),
            "mesh4": jax_mesh.create_mesh(num_data=1, num_model=4, devices=devices),
            "hybrid": jax_mesh.create_hybrid_mesh(num_slices=2, num_data=1, num_model=2, devices=devices)}


def jax_trace(opt_state):
    """The momentum trace inside an optax state of nested tuples."""
    if hasattr(opt_state, "trace"):
        return opt_state.trace
    for part in opt_state if isinstance(opt_state, (tuple, list)) else ():
        found = jax_trace(part)
        if found is not None:
            return found
    return None


def jax_tp_steps(mesh, batches: list[dict], learnable_softplus: bool = False) -> dict:
    """The JAX package's TP steps: losses, weights, EMA, momentum (port names), and the shards' shapes."""
    params = worker.tp_params(worker.SGD_MOMENTUM, learnable_softplus=learnable_softplus)
    model = JaxMouseModel(params, mesh=mesh)
    model.set_ema(worker.EMA_DECAY)
    model.build_state(seed=0, learning_rate=worker.LR)
    assert model.tensor_parallel
    losses = [float(model.train_step(JaxMiceBatch(**batch))) for batch in batches]
    state = model.state

    def shards(value):
        return {s.data.shape for s in value.addressable_shards}

    trace = jax_trace(state.opt_state)
    out = {"losses": losses,
           "state": from_jax_variables(jax.device_get(state.params), jax.device_get(state.batch_stats)),
           "ema": from_jax_variables(jax.device_get(state.ema_params), jax.device_get(state.ema_batch_stats)),
           "momentum": from_jax_variables(jax.device_get(trace), {}),
           "shapes": {"live": shards(state.params["readout_kernel"]),
                      "ema": shards(state.ema_params["readout_kernel"]),
                      "momentum": shards(trace["readout_kernel"]),
                      "cortex": shards(state.params["cortex_0"]["kernel"])}}
    return {k: ({n: np.asarray(v) for n, v in d.items()} if k in ("state", "ema", "momentum") else d)
            for k, d in out.items()}


def run_layout(job: Path, layout: str) -> subprocess.Popen:
    world, num_model, num_slices, _ = LAYOUTS[layout]
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "2"}
    port = free_port()
    extra = [str(num_model)] + ([num_slices] if num_slices else [])
    return [subprocess.Popen([sys.executable, "-m", "tests.torch_mesh_worker", str(job), str(rank), str(world),
                              str(port), *extra], cwd=REPO, env=env, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT, text=True) for rank in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """``(single, {layout: [rank outputs]}, {jax mesh kind: steps}, job dir,
    the one-process train state every layout reads)``."""
    job = tmp_path_factory.mktemp("tp_job")
    rng = np.random.default_rng(0)
    batches = {"tp0": random_batch(rng, 8), "tp1": random_batch(rng, 8)}
    inputs = {f"{name}/{key}": value for name, batch in batches.items() for key, value in batch.items()}
    inputs["probe"] = random_batch(rng, 8)["inputs"]
    inputs.update({f"tp2/{key}": value for key, value in random_batch(rng, 8).items()})
    np.savez(job / "inputs.npz", **inputs)
    init = JaxMouseModel(worker.tiny_params())
    init.build_state(seed=0, learning_rate=worker.LR)
    init.save(job / "init.ckpt")
    init = JaxMouseModel(worker.tp_params(worker.SGD_MOMENTUM, learnable_softplus=True))
    init.build_state(seed=0, learning_rate=worker.LR)
    init.save(job / "init_softplus.ckpt")
    single_model = MouseModel(worker.tp_params(worker.ADAMW), device="cpu")
    single_model.build_state(seed=3, learning_rate=worker.LR)
    single_model.save(job / "single_model.ckpt")
    single_state = worker.write_single_state(job, inputs)

    procs = {}
    for layout in LAYOUTS:
        layout_dir = job / layout
        layout_dir.mkdir()
        for name in ("inputs.npz", "init.ckpt", "init_softplus.ckpt", "single_model.ckpt", "single_state.orbax",
                     "single_state.ckpt"):
            (layout_dir / name).symlink_to(job / name)
        procs[layout] = run_layout(layout_dir, layout)
    # The references run while the ranks do.
    ordered = [batches["tp0"], batches["tp1"]]
    jax_runs = {}
    for kind, mesh in jax_meshes().items():
        jax_runs[kind] = jax_tp_steps(mesh, ordered)
        jax_runs[f"{kind}/softplus"] = jax_tp_steps(mesh, ordered, learnable_softplus=True)
    single = worker.run_tp_scenarios(None, dict(np.load(job / "inputs.npz")), job, "single")
    ranks = {}
    for layout, layout_procs in procs.items():
        outputs = [proc.communicate(timeout=WORKER_TIMEOUT)[0] for proc in layout_procs]
        for rank, (proc, out) in enumerate(zip(layout_procs, outputs)):
            assert proc.returncode == 0, f"{layout} rank {rank}:\n{out}"
        ranks[layout] = [dict(np.load(job / layout / f"rank{rank}.npz")) for rank in range(len(layout_procs))]
    return single, ranks, jax_runs, job, single_state


def tree(out: dict, prefix: str) -> dict:
    return {key[len(prefix):]: value for key, value in out.items() if key.startswith(prefix)}


def assert_close(got: dict, expected: dict, kind: str, label: str) -> None:
    """``kind``: "weights" (live or EMA, BN statistics included) or "momentum"."""
    assert expected and set(got) == set(expected), label
    for name, value in expected.items():
        if kind == "momentum":
            rtol, atol = (0.0, MOMENTUM_DW_ATOL) if "dw_kernel" in name else (MOMENTUM_RTOL, MOMENTUM_ATOL)
        elif name.endswith((".mean", ".var")):
            rtol, atol = STATS_RTOL, STATS_ATOL
        else:
            rtol, atol = (0.0, DW_ATOL) if "dw_kernel" in name else (PARAM_RTOL, PARAM_ATOL)
        np.testing.assert_allclose(got[name], value, rtol=rtol, atol=atol, err_msg=f"{label} {name}")


@pytest.mark.parametrize("layout", LAYOUTS)
def test_tp_step_matches_one_process_and_jax(runs, layout):
    """Two SGD-momentum steps with an EMA: the losses, weights, BN
    statistics, EMA and momentum of every rank against one process and
    against the JAX package's TP step over the same batches."""
    single, ranks, jax_runs, _, _ = runs
    reference = jax_runs[LAYOUTS[layout][3]]
    for rank, out in enumerate(ranks[layout]):
        np.testing.assert_allclose(out["sgdm/losses"], single["sgdm/losses"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(out["sgdm/losses"], reference["losses"], rtol=LOSS_RTOL)
        for part, kind in (("state", "weights"), ("ema", "weights"), ("momentum", "momentum")):
            got = tree(out, f"sgdm/{part}/")
            assert_close(got, tree(single, f"sgdm/{part}/"), kind, f"{layout} rank {rank} {part} vs one process:")
            assert_close(got, reference[part], kind, f"{layout} rank {rank} {part} vs jax:")


@pytest.mark.parametrize("layout", LAYOUTS)
def test_learnable_softplus_betas_get_the_whole_gradient(runs, layout):
    """The betas are replicated and each rank applies them to its row slice
    only: their gradient is summed over the model group, so the step is one
    process's and the JAX package's, and a model group's ranks hold the same
    betas bitwise."""
    single, ranks, jax_runs, _, _ = runs
    reference = jax_runs[f"{LAYOUTS[layout][3]}/softplus"]
    betas = single["softplus/state/readout_softplus_beta"]
    assert not np.allclose(betas, worker.TINY_NN["softplus_beta"], rtol=0.0, atol=PARAM_ATOL)  # the steps move them
    outs = ranks[layout]
    for rank, out in enumerate(outs):
        np.testing.assert_allclose(out["softplus/losses"], single["softplus/losses"], rtol=LOSS_RTOL)
        np.testing.assert_allclose(out["softplus/losses"], reference["losses"], rtol=LOSS_RTOL)
        for part, kind in (("state", "weights"), ("ema", "weights"), ("momentum", "momentum")):
            got = tree(out, f"softplus/{part}/")
            assert_close(got, tree(single, f"softplus/{part}/"), kind, f"{layout} rank {rank} {part} vs one process:")
            assert_close(got, reference[part], kind, f"{layout} rank {rank} {part} vs jax:")
    for first, second in zip(outs[::2], outs[1::2]):  # the ranks of each model group
        replicated = tree(first, "softplus/replicated/")
        assert "readout_softplus_beta" in replicated
        for name, value in replicated.items():
            np.testing.assert_array_equal(second[f"softplus/replicated/{name}"], value, err_msg=name)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_shards_are_jaxs(runs, layout):
    """The readout kernel's slice in the live weights, the EMA copy and the
    momentum, and a cortex kernel's, are the JAX package's shard shapes."""
    _, ranks, jax_runs, _, _ = runs
    shapes = jax_runs[LAYOUTS[layout][3]]["shapes"]
    for out in ranks[layout]:
        for name in ("live", "ema", "momentum", "cortex"):
            assert {tuple(out[f"shapes/{name}"])} == shapes[name], name


@pytest.mark.parametrize("layout", LAYOUTS)
def test_ranks_place_by_jax_device_order(runs, layout):
    """Global rank r: model index r % m, data index r // m, for a model axis of m."""
    _, ranks, _, _, _ = runs
    num_model = LAYOUTS[layout][1]
    for rank, out in enumerate(ranks[layout]):
        assert out["mesh/index"].tolist() == [rank // num_model, rank % num_model]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_drop_rates_on_keep_a_model_groups_replicas_bitwise(runs, layout):
    """The masks are drawn for the global batch on every rank: the ranks of a
    model group hold bitwise-equal replicated weights, and the step is one
    process's."""
    single, ranks, _, _, _ = runs
    outs = ranks[layout]
    for out in outs:
        np.testing.assert_allclose(out["dropout/losses"], single["dropout/losses"], rtol=LOSS_RTOL)
        assert_close(tree(out, "dropout/state/"), tree(single, "dropout/state/"), "weights", f"{layout} dropout:")
    for first, second in zip(outs[::2], outs[1::2]):  # the ranks of each model group
        replicated = tree(first, "dropout/replicated/")
        assert replicated
        for name, value in replicated.items():
            np.testing.assert_array_equal(second[f"dropout/replicated/{name}"], value, err_msg=name)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_adamw_with_a_global_norm_clip_matches_one_process(runs, layout):
    """Every step clipped: the norm is the whole model's, the sharded
    gradients' squares summed over the model group."""
    single, ranks, _, _, _ = runs
    for out in ranks[layout]:
        # Adam's update hardly sees the gradient's scale: hold the norm itself too.
        assert out["sgdm/grad_norm"] == pytest.approx(float(single["sgdm/grad_norm"]), rel=LOSS_RTOL)
        np.testing.assert_allclose(out["adamw_clip/losses"], single["adamw_clip/losses"], rtol=LOSS_RTOL)
        for part in ("state", "ema"):
            assert_close(tree(out, f"adamw_clip/{part}/"), tree(single, f"adamw_clip/{part}/"), "weights",
                         f"{layout} adamw {part}:")


@pytest.mark.parametrize("layout", LAYOUTS)
def test_predict_and_load_model_over_a_model_axis(runs, layout):
    """``predict`` on the EMA weights after the steps, and ``load_model(mesh=)``
    of a one-process checkpoint: one mouse and all mice."""
    single, ranks, _, _, _ = runs
    for out in ranks[layout]:
        for key in ("predict/mouse1", "predict/all", "load_model/mouse1", "load_model/all"):
            assert out[key].shape == single[key].shape
            np.testing.assert_allclose(out[key], single[key], rtol=PREDICT_RTOL, atol=PREDICT_ATOL, err_msg=key)


@pytest.mark.parametrize("layout", LAYOUTS)
def test_msgpack_files_under_tp_are_one_process_bytes(runs, layout):
    """The model checkpoint and the train state written under a model axis
    are byte for byte one process's from the same values; the stepped train
    state read by one process and written again is the same bytes."""
    _, _, _, job, _ = runs
    tp_files, single_files = job / layout / LABELS[layout], job / "single"
    for name in ("model.ckpt", "state.ckpt"):
        assert (tp_files / name).read_bytes() == (single_files / name).read_bytes(), name
    model = MouseModel(worker.tp_params(worker.SGD_MOMENTUM), device="cpu")
    model.set_ema(worker.EMA_DECAY)
    model.build_state(seed=5, learning_rate=worker.LR)
    assert model.load_train_state(tp_files / "stepped_state.ckpt") == {"epoch": 1} and model.state.step == 2
    model.save_train_state(job / f"{layout}_again.ckpt", extra={"epoch": 1})
    assert (job / f"{layout}_again.ckpt").read_bytes() == (tp_files / "stepped_state.ckpt").read_bytes()
    # Only the first process writes: the layout's directory holds one set of files.
    assert sorted(p.name for p in tp_files.iterdir()) == ["model.ckpt", "saved_state.ckpt", "state.ckpt",
                                                         "stepped_state.ckpt", "train_state.orbax"]


@pytest.mark.parametrize("layout", LAYOUTS)
def test_orbax_round_trip_restores_and_continues_bitwise(runs, layout):
    """``TestShardedCheckpoint``'s checks: ``extra``, the step, the shard
    shapes, the restored values bitwise (live, EMA, momentum, generator) and
    a continued step, bitwise in the port."""
    _, ranks, _, job, _ = runs
    for out in ranks[layout]:
        assert int(out["orbax/epoch"]) == 2 and int(out["orbax/step"]) == 1
        assert tuple(out["orbax/shape"]) == tuple(out["shapes/live"])
        assert bool(out["orbax/restored_bitwise"]) and bool(out["orbax/continued_bitwise"])
        losses = out["orbax/continued_losses"]
        assert losses[0] == losses[1] and np.isfinite(losses).all()
    orbax = job / layout / LABELS[layout] / "train_state.orbax"
    assert (orbax / "meta.json").is_file() and (orbax / "state" / ".metadata").is_file()


def assert_bitwise(got: dict, expected: dict, label: str) -> None:
    assert expected and set(got) == set(expected), label
    for name, value in expected.items():
        np.testing.assert_array_equal(got[name], value, err_msg=f"{label} {name}")


def assert_continues(got: dict, uninterrupted: dict, label: str) -> None:
    """Two steps after a resume against the uninterrupted run: its first step
    summed in another order (another model axis size), so at
    ``test_tp_step_matches_one_process_and_jax``'s bounds."""
    np.testing.assert_allclose(got["losses"], uninterrupted["losses"][1:], rtol=LOSS_RTOL, err_msg=label)
    for part, kind in (("state", "weights"), ("ema", "weights"), ("momentum", "momentum")):
        assert_close(tree(got, f"{part}/"), tree(uninterrupted, f"{part}/"), kind, f"{label} {part}:")


def read_on_one_process(written: Path, twin: Path, inputs: dict) -> dict:
    """A ``.orbax`` state and the msgpack state of the same values, each read
    by a one-process model that then takes the two resumed steps: extra, the
    step, the restored values and the continued ones (``_record_tp``)."""
    out: dict = {}
    models = []
    for path in (written, twin):
        model = MouseModel(worker.tp_params(worker.SGD_MOMENTUM), device="cpu")
        model.set_ema(worker.EMA_DECAY)
        model.build_state(seed=9, learning_rate=worker.LR)
        out["epoch"] = model.load_train_state(path)["epoch"]
        models.append(model)
    out["step"] = models[0].state.step
    worker._record_tp(out, "restored", models[0])
    out["twin_bitwise"] = worker._bitwise(worker._local(models[0]), worker._local(models[1]))
    losses = [[float(m.train_step(worker._batch(inputs, n))) for n in worker.RESUMED] for m in models]
    out["twin_losses"] = losses[1]
    out["continued_bitwise"] = worker._bitwise(worker._local(models[0]), worker._local(models[1]))
    worker._record_tp(out, "continued", models[0], losses[0])
    return out


@pytest.mark.parametrize("layout", LAYOUTS)
def test_orbax_of_another_model_axis_resumes(runs, layout):
    """A ``.orbax`` state read over another model axis size is resliced.
    One process's state (model 1) on every rank of the layout (model 2 or
    4), and a rank's state (model 2 or 4) on one process: the restored
    values, gathered whole, are the saved ones bitwise (live, EMA, momentum,
    step, generator); two more steps are bitwise those of the same values
    read from the msgpack train state on the same mesh, and within the TP
    bounds of the run that was not interrupted."""
    single, ranks, _, job, saved = runs
    inputs = dict(np.load(job / "inputs.npz"))
    for rank, out in enumerate(ranks[layout]):
        label = f"{layout} rank {rank}"
        assert int(out["reshard/epoch"]) == 3 and int(out["reshard/step"]) == 1
        np.testing.assert_array_equal(out["reshard/generator"], saved["generator"])
        for part in ("state", "ema", "momentum"):
            assert_bitwise(tree(out, f"reshard/restored/{part}/"), tree(saved, f"saved/{part}/"), f"{label} {part}")
        assert bool(out["reshard/twin_bitwise"]) and bool(out["reshard/continued_bitwise"])
        losses = out["reshard/continued_losses"]
        assert np.array_equal(losses[0], losses[1]) and np.isfinite(losses).all()
        assert_continues({"losses": losses[0], **tree(out, "reshard/continued/")},
                         {"losses": out["uninterrupted/losses"], **tree(out, "uninterrupted/")}, label)

    files = job / layout / LABELS[layout]
    back = read_on_one_process(files / "train_state.orbax", files / "saved_state.ckpt", inputs)
    assert back["epoch"] == 2 and back["step"] == 1
    for part in ("state", "ema", "momentum"):
        assert_bitwise(tree(back, f"restored/{part}/"), tree(ranks[layout][0], f"orbax_saved/{part}/"),
                       f"{layout} on one process {part}")
    assert back["twin_bitwise"] and back["continued_bitwise"]
    assert back["continued/losses"].tolist() == back["twin_losses"]
    assert_continues(tree(back, "continued/"), tree(single, "uninterrupted/"), f"{layout} on one process")


def test_one_process_orbax_round_trip(runs):
    """The same scenario without a mesh: the sharded format needs no process
    group; a state written over a model axis of 2 reads back on one process,
    resliced, to the values the ranks saved."""
    single, ranks, _, job, saved = runs
    assert int(single["orbax/epoch"]) == 2 and bool(single["orbax/restored_bitwise"])
    assert bool(single["orbax/continued_bitwise"])
    assert int(single["reshard/step"]) == 1 and bool(single["reshard/continued_bitwise"])
    assert_bitwise(tree(single, "reshard/restored/state/"), tree(saved, "saved/state/"), "one process")
    files = job / "d1m2" / LABELS["d1m2"]
    back = read_on_one_process(files / "train_state.orbax", files / "saved_state.ckpt",
                               dict(np.load(job / "inputs.npz")))
    assert_bitwise(tree(back, "restored/state/"), tree(ranks["d1m2"][0], "orbax_saved/state/"), "model 2 -> 1")
    assert back["twin_bitwise"] and back["continued_bitwise"]


def test_jax_written_orbax_directory_is_refused(tmp_path):
    """Neither package reads the other's ``.orbax``: the JAX package's
    (orbax) has no torch.distributed.checkpoint metadata."""
    jax_model = JaxMouseModel(worker.tiny_params())
    jax_model.build_state(seed=0, learning_rate=worker.LR)
    jax_model.save_train_state(tmp_path / "train_state.orbax", extra={"epoch": 0})
    model = MouseModel(worker.tiny_params(), device="cpu")
    model.build_state(seed=0, learning_rate=worker.LR)
    with pytest.raises(ValueError, match="no torch.distributed.checkpoint metadata"):
        model.load_train_state(tmp_path / "train_state.orbax")
    shutil.rmtree(tmp_path / "train_state.orbax")


def test_cli_over_a_model_axis_with_the_sharded_state_matches_one_process(tmp_path):
    """Two ``cli.train`` processes (gloo ranks 0 and 1: ``{data: 1, model:
    2}``) sharing one data directory train fold 2 from one JAX-written
    ``init_from`` checkpoint (CutMix and the drop rates off), every epoch's
    logs one process's at ``tests/test_torch_multihost.py``'s tolerances;
    the resume state is the directory ``train_state.orbax``, and ``--resume``
    over the two processes reads it back (both stages done: nothing left)."""
    build_synthetic_dataset(tmp_path / "dataset" / "sensorium_all_2023")
    config = tiny_experiment_config()
    nn_params = config["argus_params"]["nn_module"][1]
    nn_params["drop_rate"] = nn_params["drop_path_rate"] = 0.0
    config.pop("cutmix", None)
    config.update(num_epochs=[1, 1], train_epoch_size=40)
    init = JaxMouseModel(config["argus_params"])
    init.build_state(seed=7, learning_rate=1e-3)
    init.save(tmp_path / "init.ckpt")
    config["init_from"] = str(tmp_path / "init.ckpt")
    (tmp_path / "configs").mkdir()
    (tmp_path / "configs" / "tiny_tp.py").write_text(f"config = {config!r}\n")
    env = {**os.environ, "PYTHONPATH": str(REPO), "SENSORIUM_CONFIGS_DIR": str(tmp_path / "configs"),
           "SENSORIUM_FOLD_ASSIGNMENT": "trial", "OMP_NUM_THREADS": "2"}
    argv = ["-e", "tiny_tp", "-f", "2", "--device", "cpu"]
    shared, one = data_dir(tmp_path, "shared"), data_dir(tmp_path, "one")

    def tp_run(*flags):
        port = free_port()
        return [start("sensorium_tpu_torch.cli.train",
                      [*argv, "--mesh", "data,model", "--sharded-checkpoint", *flags,
                       "--multihost", f"127.0.0.1:{port},2,{pid}"], env, shared) for pid in range(2)]

    outputs = finish(tp_run() + [start("sensorium_tpu_torch.cli.train", argv, env, one)])
    for pid, out in enumerate(outputs[:2]):
        assert f"Mesh: {{'data': 1, 'model': 2}}, process {pid} of 2" in out
    fold = shared / "experiments" / "tiny_tp" / "fold_2"
    assert (fold / "train_state.orbax" / "meta.json").is_file() and not (fold / "train_state.ckpt").exists()
    assert list(fold.glob("model-*.ckpt"))
    sharded, single = read_records(fold), read_records(one / "experiments" / "tiny_tp" / "fold_2")
    assert [(r["stage"], r["epoch"]) for r in sharded] == [(r["stage"], r["epoch"]) for r in single]
    assert [(r["stage"], r["epoch"]) for r in single] == [("warmup", 0), ("train", 1)]
    for got, want in zip(sharded, single):
        for key in ("train_loss", "val_loss"):
            np.testing.assert_allclose(got[key], want[key], rtol=LOG_LOSS_RTOL, err_msg=key)
        corr_keys = [k for k in want if k.startswith("val_corr")]
        assert corr_keys and set(corr_keys) <= set(got)
        for key in corr_keys:
            np.testing.assert_allclose(got[key], want[key], atol=CORR_ATOL, err_msg=key)

    for out in finish(tp_run("--resume")):
        assert "Resumed from epoch 2" in out and "Stage 'train' already completed" in out
    assert len(read_records(fold)) == 2
