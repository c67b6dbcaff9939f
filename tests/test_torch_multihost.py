"""The port's ``--multihost`` train and predict CLIs, two processes on the CPU.

After ``tests/test_multihost.py``: two ``cli.train --multihost
127.0.0.1:PORT,2,ID --device cpu`` processes (one gloo rank each) train
fold 2 of the tiny config from one ``init_from`` checkpoint that the JAX
package wrote, CutMix and the drop rates off; every global batch of 8 rows
is 4 rows a process, so the BN statistics, the loss and the gradients are
reduced across the process boundary. Their per-epoch logs must be a
one-process run's at ``tests/test_torch_fit.py``'s tolerances, and process
1, pointed at a data directory of its own, writes no file. Then two
``cli.predict --multihost`` processes split the trials of an unlabeled
split; the predictions and the submission are one process's, byte for byte.
"""

from __future__ import annotations

import json
import os
import shutil
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from sensorium_tpu.engine.model import MouseModel as JaxMouseModel
from tests.synthetic import build_synthetic_dataset, tiny_experiment_config

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 600  # seconds; a process takes ~15
LOSS_RTOL = 1e-3  # tests/test_torch_fit.py
CORR_ATOL = 1e-4
FOLD = "2"


def free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def data_dir(root: Path, name: str) -> Path:
    """A data directory of its own that links the one dataset."""
    path = root / name
    path.mkdir()
    (path / "sensorium_all_2023").symlink_to(root / "dataset" / "sensorium_all_2023", target_is_directory=True)
    return path


def start(module: str, argv: list[str], env: dict, data: Path) -> subprocess.Popen:
    return subprocess.Popen([sys.executable, "-m", module, *argv], cwd=REPO,
                            env={**env, "SENSORIUM_DATA_DIR": str(data)}, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def finish(procs: list[subprocess.Popen]) -> list[str]:
    outputs = [proc.communicate(timeout=TIMEOUT)[0] for proc in procs]
    for proc, out in zip(procs, outputs):
        assert proc.returncode == 0, out
    return outputs


def tree_bytes(root: Path) -> dict[str, bytes]:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tmp_path_factory.mktemp("multihost")
    # 3 unlabeled trials a new mouse: over 2 processes the shards are [0, 2] and [1].
    build_synthetic_dataset(root / "dataset" / "sensorium_all_2023", test_trials=3)
    return root


@pytest.fixture(scope="module")
def env(root):
    return {**os.environ, "PYTHONPATH": str(REPO), "SENSORIUM_CONFIGS_DIR": str(root / "configs"),
            "SENSORIUM_FOLD_ASSIGNMENT": "trial", "OMP_NUM_THREADS": "2"}


def read_records(fold_dir: Path) -> list[dict]:
    return [json.loads(line) for line in (fold_dir / "log.jsonl").read_text().splitlines()]


def test_two_process_training_matches_one_process(root, env):
    config = tiny_experiment_config()
    nn_params = config["argus_params"]["nn_module"][1]
    nn_params["drop_rate"] = nn_params["drop_path_rate"] = 0.0
    config.pop("cutmix", None)
    config.update(num_epochs=[1, 1], train_epoch_size=40)
    init = JaxMouseModel(config["argus_params"])
    init.build_state(seed=7, learning_rate=1e-3)
    init.save(root / "init.ckpt")
    config["init_from"] = str(root / "init.ckpt")
    (root / "configs").mkdir()
    (root / "configs" / "tiny_mh.py").write_text(f"config = {config!r}\n")

    argv = ["-e", "tiny_mh", "-f", FOLD, "--device", "cpu"]
    port = free_port()
    dirs = [data_dir(root, name) for name in ("process0", "process1", "one")]
    procs = [start("sensorium_tpu_torch.cli.train", [*argv, "--multihost", f"127.0.0.1:{port},2,{pid}"], env, d)
             for pid, d in enumerate(dirs[:2])]
    procs.append(start("sensorium_tpu_torch.cli.train", argv, env, dirs[2]))
    outputs = finish(procs)
    for pid, out in enumerate(outputs[:2]):
        assert f"Multihost: process {pid}/2, 2 global devices (gloo, cpu)" in out
        assert "Mesh: {'data': 2, 'model': 1}" in out

    fold = Path("experiments") / "tiny_mh" / f"fold_{FOLD}"
    assert not (dirs[1] / "experiments").exists(), "process 1 wrote files"
    assert (dirs[0] / "experiments" / "tiny_mh" / "config.json").exists()
    assert list((dirs[0] / fold).glob("model-*.ckpt")) and (dirs[0] / fold / "train_state.ckpt").exists()
    sharded, single = read_records(dirs[0] / fold), read_records(dirs[2] / fold)
    assert [(r["stage"], r["epoch"]) for r in sharded] == [(r["stage"], r["epoch"]) for r in single]
    assert [(r["stage"], r["epoch"]) for r in single] == [("warmup", 0), ("train", 1)]
    for got, want in zip(sharded, single):
        for key in ("train_loss", "val_loss"):
            np.testing.assert_allclose(got[key], want[key], rtol=LOSS_RTOL, err_msg=key)
        corr_keys = [k for k in want if k.startswith("val_corr")]
        assert corr_keys and set(corr_keys) <= set(got)
        for key in corr_keys:
            np.testing.assert_allclose(got[key], want[key], atol=CORR_ATOL, err_msg=key)
        np.testing.assert_allclose(got["lr"], want["lr"], rtol=1e-6)


def test_two_process_predict_matches_one_process(root, env):
    """``trial_shard = (rank, 2)``: each process predicts its trials, then a
    barrier, then process 0 writes the submission."""
    from sensorium_tpu_torch import constants
    from sensorium_tpu_torch.engine.model import MouseModel

    config = tiny_experiment_config()
    shared, one = data_dir(root, "predict_shared"), data_dir(root, "predict_one")
    for i, fold_split in enumerate(constants.folds_splits):
        model = MouseModel(config["argus_params"], device="cpu")
        model.build_state(seed=i, learning_rate=0.0)
        fold_dir = shared / "experiments" / "tiny_pred" / fold_split
        fold_dir.mkdir(parents=True)
        model.save(fold_dir / "model-001-0.100000.ckpt")
    shutil.copytree(shared / "experiments", one / "experiments")

    argv = ["-e", "tiny_pred", "-s", "live_test_main", "--device", "cpu", "--chunk-size", "4"]
    port = free_port()
    procs = [start("sensorium_tpu_torch.cli.predict", [*argv, "--multihost", f"127.0.0.1:{port},2,{pid}"], env,
                   shared) for pid in (0, 1)]
    procs.append(start("sensorium_tpu_torch.cli.predict", argv, env, one))
    outputs = finish(procs)
    assert all("Multihost: process" in out for out in outputs[:2])

    multi, single = tree_bytes(shared / "predictions"), tree_bytes(one / "predictions")
    assert sum(p.endswith(".npy") for p in single) == 15 and any("parquet" in p for p in single)
    assert sorted(multi) == sorted(single)
    assert [p for p in single if multi[p] != single[p]] == []


def test_launcher_starts_a_rank_a_card_and_reports_their_exit(root, monkeypatch, capfd):
    """``--mesh data`` over several cards: the launcher spawns one rank a
    card into one group (here two gloo ranks on the CPU standing for two
    cards) and exits as they do: 0 after training, 1 when a rank fails."""
    from sensorium_tpu_torch import constants

    config = tiny_experiment_config()
    config.update(num_epochs=[1, 1], train_epoch_size=20)
    data = data_dir(root, "launcher")
    for name, value in (("data_dir", data), ("sensorium_dir", data / "sensorium_all_2023"),
                        ("experiments_dir", data / "experiments"), ("configs_dir", root / "configs")):
        monkeypatch.setattr(constants, name, value)
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    monkeypatch.setenv("SENSORIUM_FOLD_ASSIGNMENT", "trial")
    from sensorium_tpu_torch.cli import train

    args = train.parse_arguments(["-e", "tiny_launch", "-f", "1", "--device", "cpu"])
    train.launch_ranks(args, config, ["fold_1"], f"127.0.0.1:{free_port()},1,0", 2)
    out = capfd.readouterr().out
    assert "Ranks exited with [0, 0]" in out and "Multihost: process 1/2" in out
    assert [r["epoch"] for r in read_records(data / "experiments" / "tiny_launch" / "fold_1")] == [0, 1]

    config["init_from"] = str(root / "no_such.ckpt")
    with pytest.raises(SystemExit) as exit_info:
        train.launch_ranks(args, config, ["fold_1"], f"127.0.0.1:{free_port()},1,0", 2)
    assert exit_info.value.code == 1
