"""One run of one cell: set-up, the measured window (traced or not), the
program freed, the reference's comparison, the metrics and the result."""

from __future__ import annotations

import json
import subprocess
import sys
import time
from types import SimpleNamespace

import torch

from benchmark.harness import compare, spec
from benchmark.harness.trace import NoTrace, Tracer
from benchmark.work import counts

FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "sensorium_tpu")


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` that the run may not hold, compared whole."""
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN_MODULES))


def log(key: str, value) -> None:
    print(json.dumps({key: value}, default=str), file=sys.stderr, flush=True)


def card_line() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60, check=True).stdout
        return out.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError) as exc:
        return f"nvidia-smi unavailable: {exc}"


def _kernel_libraries() -> dict:
    from sensorium_tpu_torch.ops import _build

    return {p.stem: _build.library_path(p.stem).exists() for p in sorted(_build.SOURCE_DIR.glob("*.cu"))}


def _launches() -> dict:
    from sensorium_tpu_torch.ops import dw_kernels

    return dict(dw_kernels.LAUNCHES)


def _sync(devices) -> None:
    for device in devices:
        if device.type == "cuda":
            torch.cuda.synchronize(device)


def _peak(devices) -> int:
    """The peak of the fullest card."""
    return max(torch.cuda.max_memory_allocated(d) if d.type == "cuda" else 0 for d in devices)


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool, devices: list[torch.device],
        started: float) -> dict:
    """The result line's object. ``devices``: the cell's ``chips`` cards (or
    the CPU, in the tests). ``started`` is the host clock at the process's
    start: set-up is counted from it."""
    device = devices[0]
    card = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    rates = counts.peaks_for(card)
    log("card", {"name": card, "nvidia_smi": card_line() if device.type == "cuda" else None,
                 "torch": torch.__version__, "cuda": torch.version.cuda, "peaks": rates})
    libraries = _kernel_libraries()
    driver = spec.driver_class(cell)(cell, seed, devices)
    try:
        driver.setup()
        _sync(devices)
        setup_s = time.perf_counter() - started
        before = _launches()
        tracer = Tracer(len(devices)) if trace else NoTrace()
        with tracer:
            start = time.perf_counter()
            measured = driver.window(start + seconds)
            _sync(devices)
            window_s = time.perf_counter() - start
        launches = {k: v - before[k] for k, v in _launches().items() if v != before[k]}
        peak = _peak(devices)
        failed = driver.failed(measured)
        work = driver.work(measured, rates)
        driver.free()
        reference_start = time.perf_counter()
        numbers, details = driver.check()
        reference_s = time.perf_counter() - reference_start
    finally:
        driver.cleanup()
    built = [name for name, was in libraries.items() if not was and _kernel_libraries()[name]]
    per = measured.get("steps") or len(measured.get("chunk_sizes", [])) or 1
    log("setup", {"setup_s": setup_s, "phases": driver.phases, "kernels": "cold" if built else "warm",
                  "compiled": built})
    log("window", {"seconds": window_s, **{k: v for k, v in measured.items() if k != "chunk_sizes"},
                   "launches_per_step_or_chunk": {k: v / per for k, v in launches.items()},
                   "memory_peak_gb": peak / 1e9})
    log("reference", {"seconds": reference_s, **details})

    ctx = SimpleNamespace(setup_s=setup_s, window_s=window_s, counts=measured, work=work, rates=rates,
                          trace=tracer.summary)
    chosen = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for metric in chosen:
        value = spec.metric_reader(metric["name"], cell.bench_dir)(ctx)
        if value is not None:
            metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}
    ok, rows = compare.verdicts(numbers, cell.limits)
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"the run's process holds {found}: the benchmark and the program must not load them")
    result = {"correct": ok, "attempted": measured["attempted"], "failed": failed, "metrics": metrics,
              "device": {"platform": "gpu" if device.type == "cuda" else device.type, "kind": card,
                         "count": len(devices), "memory_peak_bytes": peak}}
    if tracer.summary is not None:
        result["device"].update(busy_s=tracer.summary.busy_s, window_s=tracer.summary.window_s)
        result["breakdown"] = tracer.summary.breakdown()
    result["compared"] = {name: {"value": value, "limit": limit} for name, value, limit in rows}
    for name, value, limit in rows:
        print(f"compared {name} {value!r} limit {limit!r} {'ok' if value <= limit else 'OVER'}",
              file=sys.stderr, flush=True)
    return result
