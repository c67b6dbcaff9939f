"""The port's train CLI against the JAX package's, on the CPU.

Both packages' ``cli.train.main`` train fold 0 of one experiment config on
``tests/synthetic.py``'s dataset (the tiny config, drop rates 0, CutMix
on: the two data feeds are bit-identical, ``tests/test_torch_fit.py``),
both starting from one model checkpoint that the JAX package wrote
(``init_from``). Per epoch, the logs' losses, correlations and lr are held
at ``tests/test_torch_fit.py``'s tolerances. The cases of
``tests/test_integration.py`` follow: resume, the three-stage plan,
distillation; then the multi-device flags (the mesh a ``model`` axis
makes) and a real SIGTERM in a subprocess (exit 75, then ``--resume``).
"""

from __future__ import annotations

import csv
import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from sensorium_tpu import constants as jconstants
from sensorium_tpu.cli import train as jtrain
from sensorium_tpu.data import mouse_data as jmouse_data
from sensorium_tpu.engine.model import MouseModel as JaxMouseModel
from sensorium_tpu_torch import constants
from sensorium_tpu_torch.cli import train
from sensorium_tpu_torch.data import mouse_data
from sensorium_tpu_torch.engine.checkpoint import load_model_checkpoint
from sensorium_tpu_torch.utils.misc import get_best_model_path
from tests.synthetic import build_synthetic_dataset, tiny_experiment_config

REPO = Path(__file__).resolve().parents[1]
EXPERIMENT = "tiny_cli"
LOSS_RTOL = 1e-3  # tests/test_torch_fit.py
CORR_ATOL = 1e-4
LR_RTOL = 1e-6
CHILD_TIMEOUT = 600  # seconds; a subprocess alone takes ~10
PATHS = ("sensorium_dir", "experiments_dir", "predictions_dir", "configs_dir")


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    """The small models here run as fast on 2 threads as on all cores, and
    test workers that run side by side do not then contend for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


def cli_config(init_from: Path | None = None) -> dict:
    config = tiny_experiment_config()
    nn_params = config["argus_params"]["nn_module"][1]
    nn_params["drop_rate"] = nn_params["drop_path_rate"] = 0.0
    if init_from is not None:
        config["init_from"] = str(init_from)
    return config


def write_config(configs_dir: Path, name: str, config: dict) -> None:
    configs_dir.mkdir(parents=True, exist_ok=True)
    (configs_dir / f"{name}.py").write_text(f"config = {config!r}\n")


def splits(fold: str) -> tuple[list[str], list[str]]:
    return sorted(set(constants.folds_splits) - {fold}), [fold]


def read_logs(fold_dir: Path) -> tuple[list[dict], list[dict]]:
    with open(fold_dir / "log.csv", newline="") as handle:
        rows = list(csv.DictReader(handle))
    records = [json.loads(line) for line in (fold_dir / "log.jsonl").read_text().splitlines()]
    return rows, records


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    """The synthetic dataset; each package's constants pointed at its own
    experiments directory and at one configs directory."""
    root = tmp_path_factory.mktemp("train_cli")
    build_synthetic_dataset(root / "data" / "sensorium_all_2023")
    saved = {mod: {name: getattr(mod, name) for name in PATHS} for mod in (constants, jconstants)}
    with pytest.MonkeyPatch.context() as monkeypatch:
        monkeypatch.setenv("SENSORIUM_FOLD_ASSIGNMENT", "trial")
        monkeypatch.setenv("SENSORIUM_JAX_CACHE", "0")
        for mod, side in ((constants, "port"), (jconstants, "jax")):
            mod.sensorium_dir = root / "data" / "sensorium_all_2023"
            mod.experiments_dir = root / side / "experiments"
            mod.predictions_dir = root / side / "predictions"
            mod.configs_dir = root / "configs"
        mouse_data.get_folds_tiers.cache_clear()
        jmouse_data.get_folds_tiers.cache_clear()
        yield root
    for mod, values in saved.items():
        for name, value in values.items():
            setattr(mod, name, value)
    mouse_data.get_folds_tiers.cache_clear()
    jmouse_data.get_folds_tiers.cache_clear()


@pytest.fixture(scope="module")
def trained(env):
    """Fold 0 of EXPERIMENT trained by each package's ``main``, from one
    JAX-written ``init_from`` checkpoint; returns the two fold directories."""
    config = cli_config()
    init = JaxMouseModel(config["argus_params"])
    init.build_state(seed=7, learning_rate=1e-3)
    init.save(env / "init.ckpt")
    write_config(env / "configs", EXPERIMENT, cli_config(init_from=env / "init.ckpt"))

    argv = ["-e", EXPERIMENT, "-f", "0", "--seed", "0"]
    with pytest.MonkeyPatch.context() as monkeypatch:
        monkeypatch.setattr(sys, "argv", ["train.py", *argv, "--no-mesh"])
        jtrain.main()
    train.main([*argv, "--device", "cpu"])
    return jconstants.experiments_dir / EXPERIMENT / "fold_0", constants.experiments_dir / EXPERIMENT / "fold_0"


def test_main_matches_jax_per_epoch(trained):
    (jrows, jrecords), (rows, records) = (read_logs(d) for d in trained)
    assert [(r["stage"], r["epoch"]) for r in records] == [("warmup", 0), ("train", 1), ("train", 2)]
    assert [(r["stage"], r["epoch"]) for r in jrecords] == [(r["stage"], r["epoch"]) for r in records]
    for row, jrow in zip(rows, jrows):
        assert (row["stage"], row["epoch"]) == (jrow["stage"], jrow["epoch"])
        for key in ("train_loss", "val_loss"):
            np.testing.assert_allclose(float(row[key]), float(jrow[key]), rtol=LOSS_RTOL, err_msg=key)
        corr_keys = [k for k in jrow if k.startswith("val_corr")]
        assert len(corr_keys) == 11  # ten mice and their mean
        for key in corr_keys:
            np.testing.assert_allclose(float(row[key]), float(jrow[key]), atol=CORR_ATOL, err_msg=key)
        np.testing.assert_allclose(float(row["lr"]), float(jrow["lr"]), rtol=LR_RTOL)


def test_logs_keys_and_checkpoints_match_jax(trained):
    jdir, pdir = trained
    (jrows, jrecords), (rows, records) = read_logs(jdir), read_logs(pdir)
    assert list(rows[0]) == list(jrows[0])
    assert [list(r) for r in records] == [list(r) for r in jrecords]
    assert "val_corr" in (pdir / "log.txt").read_text()
    assert (pdir / "train_state.ckpt").exists()
    (jpath, jscore), (path, score) = (get_best_model_path(d, return_score=True) for d in trained)
    assert [p.name for p in pdir.glob("model-*.ckpt")] == [path.name]  # max_saves=1
    assert path.name.startswith(jpath.name[: len("model-000-")])  # the same epoch
    np.testing.assert_allclose(score, jscore, atol=CORR_ATOL)
    best = max(records[1:], key=lambda r: r["val_corr"])
    assert path.name == f"model-{best['epoch']:03d}-{best['val_corr']:.6f}.ckpt"
    assert load_model_checkpoint(path)["params"] == load_model_checkpoint(jpath)["params"]


def test_main_snapshots_the_config_as_jax_does(trained, env):
    jexp, exp = (d.parent for d in trained)
    assert json.loads((exp / "config.json").read_text()) == json.loads((jexp / "config.json").read_text())
    assert (exp / "config.json").read_text() == (jexp / "config.json").read_text()
    assert (exp / f"{EXPERIMENT}.py").read_text() == (env / "configs" / f"{EXPERIMENT}.py").read_text()
    assert (exp / "train.py").read_text() == Path(train.__file__).read_text()


def test_resume_skips_completed_stages_as_jax_does(trained, capsys):
    config = cli_config()
    capsys.readouterr()
    jtrain.train_mouse(config, trained[0], *splits("fold_0"), mesh=None, seed=0, resume=True)
    jout = capsys.readouterr().out
    train.train_mouse(config, trained[1], *splits("fold_0"), seed=0, resume=True, device="cpu")
    out = capsys.readouterr().out

    def lines(text):
        return [line for line in text.splitlines() if "Resumed" in line or "already completed" in line]

    assert lines(out) == lines(jout) == [
        "Resumed from epoch 3", "Stage 'warmup' already completed, skipping",
        "Stage 'train' already completed, skipping"]
    assert len(read_logs(trained[1])[1]) == 3  # nothing trained again


def test_three_stage_plan_numbers_epochs_cumulatively(env, capsys):
    config = cli_config()
    config["stages"] = ["warmup", "train", "tune"]
    config["num_epochs"] = [1, 2, 1]
    save_dir = constants.experiments_dir / "three_stage" / "fold_1"
    train.train_mouse(config, save_dir, *splits("fold_1"), seed=0, device="cpu")
    records = read_logs(save_dir)[1]
    assert [(r["stage"], r["epoch"]) for r in records] == [("warmup", 0), ("train", 1), ("train", 2), ("tune", 3)]
    # One cosine over the three post-warmup epochs: it reaches the floor at the end of 'tune'.
    assert records[1]["lr"] > records[2]["lr"] > records[3]["lr"]
    capsys.readouterr()
    train.train_mouse(config, save_dir, *splits("fold_1"), seed=0, resume=True, device="cpu")
    out = capsys.readouterr().out
    assert "Resumed from epoch 4" in out
    assert out.count("already completed") == 3


def test_distillation_from_the_teacher_fold(trained, capsys):
    config = cli_config()
    config["num_epochs"] = [1, 1]
    config["distill"] = {"experiment": EXPERIMENT, "ratio": 0.36}
    student_dir = constants.experiments_dir / "tiny_distill" / "fold_0"
    model = train.train_mouse(config, student_dir, *splits("fold_0"), seed=1, device="cpu")
    assert model.distill_ratio == pytest.approx(0.36)
    assert model.teacher_module is not None and not model.teacher_module.training
    assert f"Distillation model {get_best_model_path(trained[1])}, ratio 0.36" in capsys.readouterr().out
    assert get_best_model_path(student_dir) is not None
    records = read_logs(student_dir)[1]
    assert all(np.isfinite(r["train_loss"]) and np.isfinite(r["val_corr"]) for r in records)


def test_distillation_without_a_teacher_checkpoint_raises(env):
    config = cli_config()
    config["distill"] = {"experiment": "no_such_experiment", "ratio": 0.36}
    with pytest.raises(RuntimeError, match="No teacher checkpoint"):
        train.train_mouse(config, env / "unused", *splits("fold_0"), device="cpu")


@pytest.mark.parametrize("flags", [
    ["--mesh", "data,model"],
    ["--mesh", "replica,data,model"],
    ["--sharded-checkpoint"],
])
def test_multi_device_flags_are_refused(flags):
    """Tensor parallelism and the sharded train state, refused until they
    were ported, are accepted now (``tests/test_torch_tensor_parallel.py``
    trains with them)."""
    args = train.parse_arguments(["-e", EXPERIMENT, *flags])
    if flags[0] == "--mesh":
        assert args.mesh == flags[1] and not args.sharded_checkpoint
    else:
        assert args.sharded_checkpoint and args.mesh == "data"


@pytest.mark.parametrize("mesh, world, local, expected", [
    ("data,model", 4, 4, {"data": 2, "model": 2}),
    ("data,model", 3, 3, {"data": 3, "model": 1}),
    ("data", 4, 4, {"data": 4, "model": 1}),
    ("replica,data,model", 4, 2, {"replica": 2, "data": 1, "model": 2}),
    ("replica,data,model", 6, 3, {"replica": 2, "data": 3, "model": 1}),
])
def test_build_mesh_takes_a_model_axis_of_two_where_the_cards_are_even(mesh, world, local, expected, monkeypatch):
    """``sensorium_tpu/cli/train.py`` ``build_mesh``: 2 where the card count
    (a host's, for ``replica``) is even, else 1; over a fake process group."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    import torch.distributed as dist

    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(local))
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        assert train.build_mesh(train.parse_arguments(["-e", EXPERIMENT, "--mesh", mesh])).shape == expected
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("flags, key, value", [
    (["--mesh", "replica,data"], "mesh", "replica,data"),
    (["--fold-procs", "2"], "fold_procs", "2"),
    (["--fold-procs", "auto"], "fold_procs", "auto"),
    (["--pin-chips"], "pin_chips", True),
    (["--multihost", "auto"], "multihost", "auto"),
    (["--multihost", "127.0.0.1:1234,2,1"], "multihost", "127.0.0.1:1234,2,1"),
])
def test_data_parallel_flags_are_accepted(flags, key, value):
    assert getattr(train.parse_arguments(["-e", EXPERIMENT, *flags]), key) == value


@pytest.mark.parametrize("flags, message", [
    (["--mesh", "model"], "expected 'data' or 'replica,data'"),
    (["--fold-procs", "two"], "expected a count or 'auto'"),
])
def test_malformed_data_parallel_flags_are_refused(flags, message, capsys):
    with pytest.raises(SystemExit) as exit_info:
        train.parse_arguments(["-e", EXPERIMENT, *flags])
    assert exit_info.value.code == 2
    assert message in capsys.readouterr().err


@pytest.mark.parametrize("flags, message", [
    (["--multihost", "127.0.0.1:1234,2,0", "--fold-procs", "2"], "mutually exclusive"),
    (["--multihost", "127.0.0.1:1234,2,0", "--no-mesh"], "requires a device mesh"),
])
def test_multihost_exclusions(env, flags, message):
    with pytest.raises(SystemExit, match=message):
        train.main(["-e", EXPERIMENT, *flags])


def test_single_device_flags_are_accepted():
    args = train.parse_arguments(["-e", EXPERIMENT, "--no-mesh", "--mesh", "data", "--fold-procs", "1",
                                  "--resume", "--async-checkpoint", "--debug-nans", "--trace", "t"])
    assert (args.device, args.folds, args.seed) == ("cuda", "all", 0)
    assert args.resume and args.async_checkpoint and args.debug_nans and args.trace == "t"


def test_main_refuses_a_missing_config(env):
    with pytest.raises(RuntimeError, match="does not exist"):
        train.main(["-e", "no_such_config", "--device", "cpu"])


def test_sigterm_exits_75_and_resume_completes(env):
    """``python -m sensorium_tpu_torch.cli.train`` in a subprocess: a SIGTERM
    once the warmup epoch is logged saves the train state and exits 75; the
    rerun with ``--resume`` completes, each epoch logged once."""
    config = cli_config()
    config["train_epoch_size"] = 80  # 10 steps an epoch
    config["num_epochs"] = [1, 4]
    write_config(env / "configs", "tiny_sigterm", config)
    run_env = {**os.environ, "PYTHONPATH": str(REPO), "SENSORIUM_DATA_DIR": str(env / "sigterm"),
               "SENSORIUM_CONFIGS_DIR": str(env / "configs"), "SENSORIUM_FOLD_ASSIGNMENT": "trial",
               "OMP_NUM_THREADS": "2"}
    (env / "sigterm").mkdir()
    (env / "sigterm" / "sensorium_all_2023").symlink_to(env / "data" / "sensorium_all_2023")
    fold_dir = env / "sigterm" / "experiments" / "tiny_sigterm" / "fold_2"
    command = [sys.executable, "-m", "sensorium_tpu_torch.cli.train", "-e", "tiny_sigterm", "-f", "2",
               "--device", "cpu"]
    proc = subprocess.Popen(command, env=run_env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            text=True)
    deadline = time.monotonic() + CHILD_TIMEOUT
    log = fold_dir / "log.jsonl"
    while time.monotonic() < deadline and proc.poll() is None:
        if log.exists() and '"warmup"' in log.read_text():
            break
        time.sleep(0.05)
    assert proc.poll() is None, f"the run ended before the signal:\n{proc.communicate()[0]}"
    proc.send_signal(signal.SIGTERM)
    out, _ = proc.communicate(timeout=CHILD_TIMEOUT)
    assert proc.returncode == 75, out
    assert "Rerun with --resume" in out
    assert (fold_dir / "train_state.ckpt").exists()
    interrupted = [r["epoch"] for r in read_logs(fold_dir)[1]]
    assert interrupted[0] == 0 and len(interrupted) < 5

    resumed = subprocess.run([*command, "--resume"], env=run_env, cwd=REPO, capture_output=True, text=True,
                             timeout=CHILD_TIMEOUT)
    assert resumed.returncode == 0, resumed.stdout + resumed.stderr
    assert f"Resumed from epoch {interrupted[-1] + 1}" in resumed.stdout
    records = read_logs(fold_dir)[1]
    assert [r["epoch"] for r in records] == list(range(5))
    assert [r["stage"] for r in records] == ["warmup"] + ["train"] * 4
    assert get_best_model_path(fold_dir) is not None


def test_train_runs_on_the_card_unless_asked_for_the_cpu(trained):
    """``--device`` defaults to cuda; without a card the CLI raises and does not go on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["-e", EXPERIMENT, "-f", "1"])
    assert not (constants.experiments_dir / EXPERIMENT / "fold_1").exists()


def test_main_with_the_nan_sanitizer_and_a_trace(env):
    """``--debug-nans`` trains a clean fold without raising and is off again
    afterwards; ``--trace`` writes the first fold's profile."""
    config = cli_config()
    config["num_epochs"] = [1, 1]
    config["train_epoch_size"] = 20
    write_config(env / "configs", "tiny_debug", config)
    train.main(["-e", "tiny_debug", "-f", "3,4", "--device", "cpu", "--debug-nans", "--trace",
                str(env / "trace")])
    assert not torch.is_anomaly_enabled()
    assert len(list((env / "trace").glob("*.pt.trace.json"))) == 1  # the first fold only
    for fold in ("fold_3", "fold_4"):
        records = read_logs(constants.experiments_dir / "tiny_debug" / fold)[1]
        assert [r["epoch"] for r in records] == [0, 1]
