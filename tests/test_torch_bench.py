"""The port's benchmark program (``sensorium_tpu_torch/tools/bench.py``) on the CPU.

Its workload is held to the JAX bench's (``bench.py``, loaded by its path
as ``tests/test_utils.py`` loads it): the flagship params under every
override, the synthetic batch and the synthetic data tree, byte for byte,
and ``child_mode_result`` on the JAX tests' cases. Then every mode runs
through ``main([..., "--device", "cpu"])`` on the tiny config of
``tests/synthetic.py`` (batch 2, one warm-up and two timed steps, 4-frame
windows on a 16x16 canvas over ``build_synthetic_dataset``'s trials): one
JSON line with the JAX bench's metric name and a finite positive value.
``--ab`` runs its two children in this process; ``--all`` gets canned
children. The headline on the card is ``tests/test_torch_cuda.py``'s.
"""

from __future__ import annotations

import contextlib
import importlib.util
import io
import json
import math
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from sensorium_tpu_torch.tools import bench
from tests.synthetic import build_synthetic_dataset, tiny_experiment_config

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def jax_bench():
    if "sensorium_bench" not in sys.modules:
        spec = importlib.util.spec_from_file_location("sensorium_bench", REPO / "bench.py")
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        sys.modules["sensorium_bench"] = module
    return sys.modules["sensorium_bench"]


def without_device(params: dict) -> dict:
    """The port's configs name the card where the JAX package's name the TPU."""
    return {k: v for k, v in params.items() if k != "device"}


OVERRIDES = {
    "shipped": {},
    "remat_off": {"SENSORIUM_REMAT": "0"},
    "first_two": {"SENSORIUM_REMAT_BLOCKS": "2"},
    "index_set": {"SENSORIUM_REMAT_BLOCKS": "0,7,8"},
    "one_index": {"SENSORIUM_REMAT_BLOCKS": "1,"},
    "nodrop": {"SENSORIUM_BENCH_NODROP": "1"},
}


@pytest.mark.parametrize("override", OVERRIDES)
def test_flagship_params_are_the_jax_benchs(jax_bench, monkeypatch, override):
    for name in ("SENSORIUM_REMAT", "SENSORIUM_REMAT_BLOCKS", "SENSORIUM_BENCH_NODROP"):
        monkeypatch.delenv(name, raising=False)
    for name, value in OVERRIDES[override].items():
        monkeypatch.setenv(name, value)
    got, expected = bench._flagship_params(), jax_bench._flagship_params()
    assert without_device(got) == without_device(expected)
    assert got["device"] == "cuda"


def test_distill_params_are_the_jax_configs():
    from importlib.machinery import SourceFileLoader

    student, teacher = bench._distill_params()
    for got, name in ((student, "distillation_001"), (teacher, "true_batch_001")):
        path = REPO / "configs" / f"{name}.py"
        expected = SourceFileLoader(f"jax_{name}", str(path)).load_module().config["argus_params"]
        assert without_device(got) == without_device(expected), name


def test_synthetic_batch_is_the_jax_benchs_byte_for_byte(jax_bench):
    import jax

    expected = jax.device_get(jax_bench.synthetic_batch())
    got = bench.synthetic_arrays()
    assert len(got) == len(expected) == 3
    for mine, theirs in zip(got, expected):
        assert mine.dtype == theirs.dtype and mine.shape == theirs.shape
        assert mine.tobytes() == np.asarray(theirs).tobytes()


def test_synthetic_tree_is_the_jax_benchs_byte_for_byte(jax_bench, tmp_path):
    (tmp_path / "jax").mkdir()
    (tmp_path / "port").mkdir()
    jax_bench._write_synth_tree(tmp_path / "jax", length=20, trials=2)
    bench._write_synth_tree(tmp_path / "port", length=20, trials=2)

    def files(root):
        return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}

    expected, got = files(tmp_path / "jax"), files(tmp_path / "port")
    assert len(expected) == 10 * (3 + 2 * 4)
    assert got == expected


CHILD_CASES = [
    (0, 'warning noise\n{"metric": "m", "value": 1.5}\n', ""),
    (1, '{"metric": "m", "value": null, "detail": {"error": "parity"}}\n', ""),
    (3, "", ""),
    (3, "", "\n"),
    (1, '{"metric": "m", "value": null}\n', "\n"),
    (0, "not json", ""),
    (2, "no json here\n", "Traceback: boom\n"),
]


@pytest.mark.parametrize("case", range(len(CHILD_CASES)))
def test_child_mode_result_is_the_jax_benchs(jax_bench, case):
    assert bench.child_mode_result(*CHILD_CASES[case]) == jax_bench.child_mode_result(*CHILD_CASES[case])


# ------------------------------------------------------------- the modes, toy size


@pytest.fixture
def toy(monkeypatch):
    """The bench on the tiny config, on the CPU at 2 threads."""
    params = tiny_experiment_config()["argus_params"]
    monkeypatch.setattr(bench, "_flagship_params", lambda: params)
    monkeypatch.setattr(bench, "_distill_params", lambda: (params, params))
    monkeypatch.setattr(bench, "_write_synth_tree", lambda root, length=300, trials=4: build_synthetic_dataset(root))
    for name, value in {"BATCH": 2, "WARMUP_STEPS": 1, "MEASURE_STEPS": 2, "FRAMES": 4, "HEIGHT": 16, "WIDTH": 16,
                        "VIDEO": (12, 16), "INFER_LENGTH": 60, "LOADER_EPOCH_SIZE": 40, "FIT_EPOCH_SIZE": 20,
                        "DEVICE_BATCHES": 2}.items():
        monkeypatch.setattr(bench, name, value)
    monkeypatch.delenv("SENSORIUM_DW_IMPL", raising=False)
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield bench
    torch.set_num_threads(threads)


def run_main(capsys, *flags) -> tuple[int, dict]:
    """``main(flags + --device cpu)``: its exit code and its one stdout line."""
    rc = bench.main([*flags, "--device", "cpu"])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1, lines
    return rc, json.loads(lines[0])


MODE_FLAGS = {
    "train": [],
    "fit": ["--fit"],
    "distill": ["--distill"],
    "infer": ["--infer"],
    "infer_mesh": ["--infer-mesh"],
    "loader": ["--loader", "--threads", "1,2"],
}


@pytest.mark.parametrize("mode", MODE_FLAGS)
def test_each_mode_prints_one_line_with_the_jax_metric(toy, capsys, mode):
    rc, line = run_main(capsys, *MODE_FLAGS[mode])
    assert rc == 0
    assert (line["metric"], line["unit"]) == bench.MODES[mode]
    assert math.isfinite(line["value"]) and line["value"] > 0
    detail = line["detail"]
    assert detail["card"] == "cpu" and detail["dw_impl"] == "cuda" and "peak_memory_gb" in detail
    if mode == "train":
        assert detail["eval_clips_per_sec"] > 0 and detail["kernel_build"]["state"] == "none (cpu)"
    if mode == "fit":
        assert detail["batches_per_epoch"] == 10 and 0 <= detail["loader_wait_pct"] <= 100
        assert detail["device_fit_clips_per_sec"] > 0 and detail["bare_step_clips_per_sec"] > 0
    if mode == "distill":
        assert math.isfinite(detail["loss_first"]) and math.isfinite(detail["loss_last"])
    if mode == "infer":
        assert line["infer_device_resident_window_forwards_per_sec"] > 0
        assert detail["prediction_shape"] == [18, 60]
    if mode == "infer_mesh":
        assert detail["devices"] == ["cpu", "cpu"] and detail["mesh"] == {"data": 2, "model": 1}
        assert detail["parity_max_abs_diff"] <= bench.MESH_REL_TOL * detail["parity_scale"]
    if mode == "loader":
        assert set(detail["thread_sweep"]) == {"1", "2"} and detail["numpy_samples_per_sec"] > 0
        assert "card_demand_samples_per_sec" not in detail["feed_budget"]


def test_ab_runs_one_child_a_route(toy, capsys, monkeypatch):
    """The two children (run in this process, with the environment each
    would get): the headline is the faster route's, both are kept."""
    routes = []

    def child(cmd, env=None, **kwargs):
        assert cmd[1:3] == ["-m", "sensorium_tpu_torch.tools.bench"] and kwargs["cwd"] == bench.ROOT
        routes.append(env["SENSORIUM_DW_IMPL"])
        out = io.StringIO()
        with monkeypatch.context() as m:
            m.setenv("SENSORIUM_DW_IMPL", env["SENSORIUM_DW_IMPL"])
            with contextlib.redirect_stdout(out):
                rc = bench.main(cmd[3:])
        return subprocess.CompletedProcess(cmd, rc, out.getvalue(), "")

    monkeypatch.setattr(bench.subprocess, "run", child)
    rc, line = run_main(capsys, "--ab")
    assert rc == 0 and routes == ["cudnn", "cuda"]
    detail = line["detail"]
    assert detail["cudnn"]["dw_impl"] == "cudnn" and detail["cuda"]["dw_impl"] == "cuda"
    winner = detail["winner"]
    assert line["value"] == detail[winner]["train_clips_per_sec"] == max(
        detail[r]["train_clips_per_sec"] for r in ("cuda", "cudnn"))
    assert detail["dw_impl"] == winner and line["metric"] == bench.MODES["train"][0]


def test_trace_writes_a_trace(toy, capsys, tmp_path):
    rc, line = run_main(capsys, "--trace", str(tmp_path / "trace"))
    assert rc == 0 and line["value"] > 0
    assert list((tmp_path / "trace").glob("*.pt.trace.json"))


def canned(mode: str, value) -> str:
    metric, unit = bench.MODES[mode]
    detail = {"feed_budget": {"per_core_samples_per_sec": 120.0}} if mode == "loader" else {}
    return "log noise\n" + json.dumps({"metric": metric, "value": value, "unit": unit, "detail": detail}) + "\n"


@pytest.mark.parametrize("headline", [60.0, None])
def test_all_combines_the_children(capsys, monkeypatch, headline):
    """Each mode in a child with its flags and ``--device``; one combined
    line; the loader's feed set beside the train child's rate; exit 1 when
    the headline is null."""
    calls = []
    by_flag = {"--fit": "fit", "--distill": "distill", "--infer": "infer", "--infer-mesh": "infer_mesh",
               "--loader": "loader"}

    def child(cmd, **kwargs):
        calls.append(cmd[3:])
        mode = next((by_flag[f] for f in cmd[3:] if f in by_flag), "train")
        if mode == "train":
            return subprocess.CompletedProcess(cmd, 0 if headline else 1, canned("train", headline), "")
        return subprocess.CompletedProcess(cmd, 0, canned(mode, 12.5), "")

    monkeypatch.setattr(bench.subprocess, "run", child)
    rc, line = run_main(capsys, "--all", "--ab")
    assert calls == [["--ab", "--device", "cpu"], ["--fit", "--device", "cpu"], ["--distill", "--device", "cpu"],
                     ["--infer", "--device", "cpu"], ["--infer-mesh", "--device", "cpu"],
                     ["--loader", "--threads", "1,2,4,8", "--device", "cpu"]]
    assert line["metric"] == bench.MODES["train"][0] and line["value"] == headline
    assert set(line["detail"]) == set(bench.MODES)
    for mode in ("fit", "distill", "infer", "infer_mesh"):
        assert line["detail"][mode]["value"] == 12.5
    budget = line["detail"]["loader"]["detail"]["feed_budget"]
    if headline:
        assert rc == 0 and line["vs_baseline"] == round(headline / bench.BASELINE_CLIPS_PER_SEC, 3)
        assert budget["card_demand_samples_per_sec"] == headline and budget["cards_fed_per_core"] == 2.0
    else:
        assert rc == 1 and line["vs_baseline"] is None and "card_demand_samples_per_sec" not in budget
        assert line["detail"]["train"]["child_json"]["value"] is None


def test_no_card_prints_a_null_line_and_exits_1():
    """Without a card and without ``--device cpu`` the bench does not fall
    back to the CPU (this machine has no card)."""
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without a card")
    proc = subprocess.run([sys.executable, "-m", "sensorium_tpu_torch.tools.bench", "--infer"], cwd=REPO,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 1
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["metric"] == "infer_window_forwards_per_sec" and line["value"] is None
    assert "--device cpu" in line["detail"]["error"]
