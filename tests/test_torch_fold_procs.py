"""The port's ``cli.train --fold-procs``: folds trained concurrently, one
single-card subprocess a fold (after ``tests/test_fold_procs.py``), on the CPU.

The children run ``--device cpu`` on ``tests/synthetic.py``'s dataset with
trial-index fold assignment; each must leave what a sequential fold leaves:
a best checkpoint, the logs, and its ``train_proc.log``. A SIGTERM to the
parent goes on to the children, which save their resume state; the parent
exits 75, and ``--resume`` completes every fold.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import pytest

from sensorium_tpu_torch.cli import train
from tests.synthetic import build_synthetic_dataset, tiny_experiment_config

REPO = Path(__file__).resolve().parents[1]
TIMEOUT = 600  # seconds; a child takes ~10


@pytest.fixture(scope="module")
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp("fold_procs")
    build_synthetic_dataset(root / "data" / "sensorium_all_2023")
    (root / "configs").mkdir()
    return {**os.environ, "PYTHONPATH": str(REPO), "SENSORIUM_DATA_DIR": str(root / "data"),
            "SENSORIUM_CONFIGS_DIR": str(root / "configs"), "SENSORIUM_FOLD_ASSIGNMENT": "trial",
            "OMP_NUM_THREADS": "2"}


def write_config(env: dict, name: str, **changes) -> Path:
    config = tiny_experiment_config()
    config.update(changes)
    (Path(env["SENSORIUM_CONFIGS_DIR"]) / f"{name}.py").write_text(f"config = {config!r}\n")
    return Path(env["SENSORIUM_DATA_DIR"]) / "experiments" / name


def command(name: str, *flags: str) -> list[str]:
    return [sys.executable, "-m", "sensorium_tpu_torch.cli.train", "-e", name, "-f", "1,2", "--fold-procs", "2",
            "--device", "cpu", *flags]


def epochs(fold_dir: Path) -> list[int]:
    return [json.loads(line)["epoch"] for line in (fold_dir / "log.jsonl").read_text().splitlines()]


def test_fold_procs_trains_two_folds_at_once(env):
    experiment = write_config(env, "tiny_fp", num_epochs=[1, 1], train_epoch_size=20)
    proc = subprocess.run(command("tiny_fp"), env=env, cwd=REPO, capture_output=True, text=True, timeout=TIMEOUT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "[fold-procs] started fold_1" in proc.stdout and "[fold-procs] started fold_2" in proc.stdout
    assert (experiment / "config.json").exists()
    for fold in ("fold_1", "fold_2"):
        fold_dir = experiment / fold
        log = (fold_dir / "train_proc.log").read_text()
        assert list(fold_dir.glob("model-*.ckpt")), log
        assert (fold_dir / "log.txt").exists() and (fold_dir / "log.csv").exists()
        assert epochs(fold_dir) == [0, 1]
        assert "Data parallel" not in log  # each child trains on one device, no mesh


def test_sigterm_exits_75_and_resume_completes(env):
    experiment = write_config(env, "tiny_fp_term", num_epochs=[1, 4], train_epoch_size=80)
    proc = subprocess.Popen(command("tiny_fp_term"), env=env, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    log = experiment / "fold_1" / "log.jsonl"
    deadline = time.monotonic() + TIMEOUT
    while time.monotonic() < deadline and proc.poll() is None:
        if log.exists() and '"warmup"' in log.read_text():
            break
        time.sleep(0.05)
    assert proc.poll() is None, f"the run ended before the signal:\n{proc.communicate()[0]}"
    proc.send_signal(signal.SIGTERM)
    out, _ = proc.communicate(timeout=TIMEOUT)
    assert proc.returncode == 75, out
    assert "caught signal" in out
    assert (experiment / "fold_1" / "train_state.ckpt").exists(), out
    assert len(epochs(experiment / "fold_1")) < 5

    resumed = subprocess.run(command("tiny_fp_term", "--resume"), env=env, cwd=REPO, capture_output=True,
                             text=True, timeout=TIMEOUT)
    assert resumed.returncode == 0, resumed.stdout + resumed.stderr
    for fold in ("fold_1", "fold_2"):
        assert epochs(experiment / fold) == list(range(5)), (experiment / fold / "train_proc.log").read_text()


class FakeChild:
    def __init__(self, cmd, env, stdout, stderr):
        self.cmd, self.env, self.pid, self.returncode = cmd, env, 1000 + len(FakeChild.started), 0
        FakeChild.started.append(self)

    def poll(self):
        return self.returncode

    def terminate(self):
        pass


def test_pin_chips_gives_each_slot_its_card(tmp_path, monkeypatch):
    """``--pin-chips``: child slot i sees only card i, and runs one fold on
    one card with the parent's flags."""
    FakeChild.started = []
    monkeypatch.setattr(subprocess, "Popen", FakeChild)
    args = train.parse_arguments(["-e", "tiny", "-f", "0,1,2", "--fold-procs", "2", "--pin-chips", "--resume",
                                  "--seed", "4"])
    train.run_parallel_folds(args, ["fold_0", "fold_1", "fold_2"], tmp_path, 2)
    assert [child.env["CUDA_VISIBLE_DEVICES"] for child in FakeChild.started[:2]] == ["0", "1"]
    assert FakeChild.started[2].env["CUDA_VISIBLE_DEVICES"] in ("0", "1")  # a slot freed by a finished fold
    for child, fold in zip(FakeChild.started, "012"):
        assert child.cmd[child.cmd.index("-f") + 1] == fold
        assert {"--no-mesh", "--resume"} <= set(child.cmd) and child.cmd[child.cmd.index("--device") + 1] == "cuda"
        assert child.cmd[child.cmd.index("--seed") + 1] == "4"
    assert train.chip_pinning_env(3) == {"CUDA_VISIBLE_DEVICES": "3"}


def test_pinning_is_off_without_pin_chips(tmp_path, monkeypatch):
    FakeChild.started = []
    monkeypatch.setattr(subprocess, "Popen", FakeChild)
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    args = train.parse_arguments(["-e", "tiny", "-f", "0,1", "--fold-procs", "2", "--device", "cpu"])
    train.run_parallel_folds(args, ["fold_0", "fold_1"], tmp_path, 2)
    assert all("CUDA_VISIBLE_DEVICES" not in child.env for child in FakeChild.started)


def test_resolve_fold_procs():
    assert train.resolve_fold_procs("3") == 3
    assert train.resolve_fold_procs("auto") >= 1  # the visible cards, at least one
