"""Guards of the harness: what its modules import, that cells, traffic,
configurations and metrics are found by name, that it refuses to run
without a card, the result line's keys, and BENCHMARK.json's form."""

from __future__ import annotations

import ast
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from benchmark.harness import runner, spec
from benchmark.tests.toy import make_toy_bench

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent
REFUSED = {"jax", "jaxlib", "flax", "sensorium_tpu"}
REFERENCE_ALLOWED = {"__future__", "math", "dataclasses", "numpy", "torch", "benchmark"}
CONTRACT_KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def imported_top_levels(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {alias.name.split(".")[0] for alias in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", None) == "import_module" and node.args:
            if isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(BENCH_DIR.rglob("*.py")), ids=lambda p: str(p.relative_to(BENCH_DIR)))
def test_imports(path):
    names = imported_top_levels(path)
    # Whole top-level names: sensorium_tpu_torch is the program, sensorium_tpu is not.
    assert not names & REFUSED, f"{path} imports {names & REFUSED}"
    if "reference" in path.relative_to(BENCH_DIR).parts:
        assert names <= REFERENCE_ALLOWED, f"the reference imports {names - REFERENCE_ALLOWED}"
        if "benchmark" in names:
            assert all(m.startswith("benchmark.reference") for m in re.findall(r"from (benchmark\.\S+)",
                                                                              path.read_text()))


def test_forbidden_modules_compare_whole_names(monkeypatch):
    before = runner.forbidden_modules()
    monkeypatch.setitem(sys.modules, "sensorium_tpu_torch.lookalike", sys)
    monkeypatch.setitem(sys.modules, "jaxtyping", sys)
    assert runner.forbidden_modules() == before
    monkeypatch.setitem(sys.modules, "sensorium_tpu.constants", sys)
    assert "sensorium_tpu" in runner.forbidden_modules()


def run_toy(bench_file: Path, cell: str, trace: bool = False, seed: int = 2**31 + 17) -> dict:
    loaded = spec.load_cell(cell, bench_file, bench_file.parent / "benchmark")
    return runner.run(loaded, seed, 0.5, trace, [torch.device("cpu")], time.perf_counter())


TOY_DRIVER = '''from benchmark.drivers import predict


class Driver(predict.Driver):
    """Whole trials cut to their first ``keep_frames`` frames."""

    def setup(self):
        super().setup()
        self.plan = [(t, 0, self.traffic["keep_frames"], m) for t, _, _, m in self.plan]
'''


def test_new_files_are_found_by_name(tmp_path):
    """A configuration, a traffic mix with a driver of its own, a cell and
    per-layer metrics that exist only as new files (and entries in
    BENCHMARK.json) run with no edit; a metric without a file of its own is
    read by its family's (``device_idle_pct.half`` by ``device_idle_pct.py``)."""
    bench_file = make_toy_bench(tmp_path)
    bench_dir = bench_file.parent / "benchmark"
    (bench_dir / "drivers" / "toy_half.py").write_text(TOY_DRIVER)
    traffic = json.loads((bench_dir / "traffic" / "toy_predict.json").read_text())
    (bench_dir / "traffic" / "toy_half.json").write_text(json.dumps(dict(traffic, driver="toy_half", keep_frames=20)))
    (bench_dir / "cells" / "toy.half.json").write_text(json.dumps({"limits": {"output_gap": 1e-4}}))
    (bench_dir / "metrics" / "toy_frames.half.py").write_text(
        "def read(ctx):\n    return float(ctx.counts['windows'])\n")
    (bench_dir / "metrics" / "toy_absent.py").write_text("def read(ctx):\n    return None\n")
    bench = json.loads(bench_file.read_text())
    bench["workloads"].append({"name": "toy.half", "config": "toy", "traffic": "toy_half", "chips": 1, "why": "toy"})
    for metric in bench["end_to_end"]:
        if metric["name"] == "predict_windows_per_s":
            metric["workloads"].append("toy.half")
    bench["per_layer"] += [
        {"name": "toy_frames.half", "unit": "windows", "better": "higher", "source": "host_clock",
         "layer": "toy", "moves": "predict_windows_per_s", "workloads": ["toy.half"]},
        {"name": "device_idle_pct.half", "unit": "%", "better": "lower", "source": "device_trace",
         "layer": "device", "moves": "predict_windows_per_s", "workloads": ["toy.half"]},
        {"name": "toy_absent.half", "unit": "%", "better": "higher", "source": "host_clock", "layer": "toy",
         "moves": "predict_windows_per_s"}]
    bench_file.write_text(json.dumps(bench))
    result = run_toy(bench_file, "toy.half", trace=True)
    assert result["correct"] is True
    frame_stack = spec.argus_params(json.loads((bench_dir / "configs" / "toy.json").read_text()))["frame_stack"]
    windows = 20 - (frame_stack["size"] - 1) * frame_stack["step"]
    assert result["metrics"]["toy_frames.half"]["value"] == windows * result["attempted"] > 0
    assert "toy_absent.half" not in result["metrics"]  # a reader with nothing to read is left out
    assert set(result["metrics"]) == {"toy_frames.half", "device_idle_pct.half"}


@pytest.mark.parametrize("cell, trace", [("toy.fit", False), ("toy.predict", True)])
def test_result_line_has_the_contract_keys(tmp_path, cell, trace):
    result = run_toy(make_toy_bench(tmp_path), cell, trace)
    extra = ["breakdown"] if trace else []
    assert list(result) == CONTRACT_KEYS + extra + ["compared"]  # the compared numbers come last
    assert result["correct"] is True and result["failed"] == 0
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    if trace:
        assert set(result["device"]) >= {"busy_s", "window_s"}
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    names = {m["name"] for m in spec.load_cell(cell, tmp_path / "checkout" / "BENCHMARK.json",
                                               tmp_path / "checkout" / "benchmark").end_to_end}
    if not trace:
        assert set(result["metrics"]) == names
    assert all(set(v) == {"value", "unit"} for v in result["metrics"].values())
    assert all(set(v) == {"value", "limit"} for v in result["compared"].values())


def test_no_card_no_result():
    """Without a card the run exits with a code other than 0 and prints no
    result: it never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: this checks the run without one")
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "fit.true_batch_001", "--seed",
                           "3", "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_form():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"] and 1 <= bench["run_seconds"] <= 51
    cells = {w["name"]: w for w in bench["workloads"]}
    configs = {c["name"]: c for c in bench["configs"]}
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        config = json.loads((ROOT / c["file"]).read_text())
        assert config["reduced"] == c["reduced"] and config["source"] == c["source"]
        assert spec.port_config_differences(config, spec.port_config(config)) == []
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and NAME.match(w["name"])
        assert w["config"] in configs and len(w["why"]) <= 200 and w["chips"] == 1
        traffic = json.loads((BENCH_DIR / "traffic" / f"{w['traffic']}.json").read_text())
        assert (BENCH_DIR / "drivers" / f"{traffic['driver']}.py").exists()
        assert (BENCH_DIR / "cells" / f"{w['name']}.json").exists()
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert spec.metric_file(m["name"]).exists()
        assert set(m.get("workloads", [])) <= set(cells)
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        for cell in m["workloads"]:  # each listed cell reports the metric it moves
            assert "workloads" not in e2e[m["moves"]] or cell in e2e[m["moves"]]["workloads"]
    for name in cells:
        loaded = spec.load_cell(name)
        assert len(loaded.end_to_end) >= 2 and loaded.per_layer
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
