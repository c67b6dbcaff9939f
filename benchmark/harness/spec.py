"""What a run is made of, found by name: the cell in ``BENCHMARK.json``, its
configuration file, its traffic file and the driver that the traffic file
names, its limits and its metrics' readers.

Every configuration, traffic mix, driver, cell and metric is a file of its
own; adding one is adding a file and an entry in ``BENCHMARK.json``, with no
edit here.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    config: dict  # the configuration file's contents
    traffic: dict  # the traffic file's contents
    limits: dict  # compared number -> limit
    end_to_end: list  # the BENCHMARK.json entries this cell reports
    per_layer: list
    chips: int
    bench_dir: Path


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def reports(metric: dict, cell: str, end_to_end_names: set) -> bool:
    """Whether ``cell`` reports ``metric``: it is listed, or the metric lists
    no cells and moves (or is) an end-to-end metric the cell reports."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in end_to_end_names


def load_cell(name: str, bench_file: Path = ROOT / "BENCHMARK.json", bench_dir: Path = BENCH_DIR) -> Cell:
    bench = load_json(bench_file)
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {bench_file.name}; it has {sorted(cells)}")
    entry = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    config = load_json(bench_file.parent / configs[entry["config"]]["file"])
    traffic = load_json(bench_dir / "traffic" / f"{entry['traffic']}.json")
    limits = load_json(bench_dir / "cells" / f"{name}.json")["limits"]
    end_to_end = [m for m in bench["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    names = {m["name"] for m in end_to_end}
    per_layer = [m for m in bench["per_layer"] if reports(m, name, names)]
    return Cell(name, config, traffic, limits, end_to_end, per_layer, int(entry["chips"]), bench_dir)


def load_config(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    """A configuration file by its name (a distillation teacher's, say)."""
    return load_json(bench_dir / "configs" / f"{name}.json")


def _load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_file(name: str, bench_dir: Path = BENCH_DIR) -> Path:
    """``metrics/<name>.py``, or else the reader of the metric's family,
    ``metrics/<stem>.py`` for a name ``<stem>.<suffix>``."""
    path = bench_dir / "metrics" / f"{name}.py"
    return path if path.exists() else bench_dir / "metrics" / f"{name.split('.')[0]}.py"


def metric_reader(name: str, bench_dir: Path = BENCH_DIR):
    """The ``read(ctx)`` function of the metric's file."""
    return _load_module(metric_file(name, bench_dir), f"benchmark_metric_{name.replace('.', '_')}").read


def driver_class(cell: Cell):
    """The ``Driver`` of ``drivers/<driver>.py``, the module that the cell's
    traffic file names."""
    name = cell.traffic["driver"]
    return _load_module(cell.bench_dir / "drivers" / f"{name}.py", f"benchmark_driver_{name}").Driver


def _plain(value):
    """Tuples as lists, so that a Python config compares with its JSON copy."""
    if isinstance(value, dict):
        return {k: _plain(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return [_plain(v) for v in value]
    return value


def port_config_differences(config: dict, port_config: dict) -> list[str]:
    """The keys of the configuration file that differ from the program's own
    copy of the published config, other than those it lists as ``reduced``
    and the program-side keys it lists as ``not_compared``."""
    skip = set(config.get("reduced", [])) | set(config.get("not_compared", []))
    differences = []

    def walk(ours, theirs, path):
        for key, value in theirs.items():
            where = f"{path}{key}"
            if key in skip:
                continue
            if key not in ours:
                differences.append(f"{where}: missing")
            elif isinstance(value, dict) and isinstance(ours[key], dict):
                walk(ours[key], value, where + ".")
            elif _plain(ours[key]) != _plain(value):
                differences.append(f"{where}: {ours[key]!r} here, {value!r} in the program's config")

    walk(_recipe(config), _plain(port_config), "")
    return differences


def _recipe(config: dict) -> dict:
    """The configuration file without its own bookkeeping keys."""
    return {k: v for k, v in config.items() if k not in ("name", "source", "port_config", "reduced", "assumed",
                                                         "not_compared", "teacher_config")}


def port_config(config: dict) -> dict | None:
    """The program's own copy of the published config the file names, or None."""
    if not config.get("port_config"):
        return None
    path = ROOT / "sensorium_tpu_torch" / "configs" / f"{config['port_config']}.py"
    return _load_module(path, f"port_config_{config['port_config']}").config


def argus_params(config: dict) -> dict:
    """The program's ``argus_params`` as it is run: its own config's, which
    must equal this file's on every key but the program-side ones
    (``not_compared``), or this file's where it names no program config."""
    port = port_config(config)
    if port is None:
        params = _plain(config["argus_params"])
    else:
        differences = port_config_differences(config, port)
        if differences:
            raise ValueError(f"configuration {config['name']} differs from the program's "
                             f"configs/{config['port_config']}.py: " + "; ".join(differences))
        params = _plain(port["argus_params"])
    params["nn_module"] = [params["nn_module"][0], dict(params["nn_module"][1])]
    return params
