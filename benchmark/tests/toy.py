"""A toy benchmark folder for the CPU tests: the real harness and readers,
a float32 configuration small enough for the CPU, the real traffic files
cut to toy sizes, and limits of its own."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parents[1]

TOY_NN = {
    "readout_outputs": [6 + i for i in range(10)],
    "in_channels": 5,
    "core_features": [8, 8, 16],
    "spatial_strides": [2, 1, 2],
    "spatial_kernel": 3,
    "temporal_kernel": 3,
    "expansion_ratio": 2,
    "se_reduce_ratio": 4,
    "cortex_features": [16, 32],
    "groups": 2,
    "softplus_beta": 0.07,
    "drop_rate": 0.2,
    "drop_path_rate": 0.2,
    "dtype": "float32",
    "readout_pad_multiple": 8,
}


def toy_config(**nn) -> dict:
    return {
        "name": "toy",
        "image_size": [16, 16],
        "batch_size": 8,
        "base_lr": 1e-3,
        "min_base_lr": 1e-5,
        "ema_decay": 0.9,
        "train_epoch_size": 80,
        "num_epochs": [2],
        "stages": ["train"],
        "num_dataloader_workers": 2,
        "argus_params": {
            "nn_module": ["dwiseneuro", dict(TOY_NN, **nn)],
            "loss": ["mice_poisson", {"log_input": False, "full": False, "eps": 1e-8}],
            "optimizer": ["AdamW", {"lr": 2e-3, "weight_decay": 0.05}],
            "frame_stack": {"size": 4, "step": 2, "position": "last"},
            "inputs_processor": ["stack_inputs", {"size": [16, 16], "pad_fill_value": 0.0}],
            "responses_processor": ["identity", {}],
            "iter_size": 1,
        },
        "cutmix": {"alpha": 1.0, "prob": 0.5},
    }


TOY_TRAFFIC = {
    "fit": {"trials": 3, "frames": 40, "video": [12, 16]},
    "predict": {"frames": 40, "video": [12, 16], "distinct_trials": 3, "plan_requests": 20, "chunk_size": 8,
                "compare_answers": 3},
}

TOY_LIMITS = {
    "fit": {"loss_gap": 1e-4, "grad_gap": 1e-3, "change_gap": 3e-3, "ema_gap": 0.06},
    "predict": {"output_gap": 1e-4},
}


def make_toy_bench(tmp: Path, distill: bool = False) -> Path:
    """A copy of the benchmark folder with toy cells ``toy.<traffic>`` (and
    ``toy_distill.fit``); returns the folder's ``BENCHMARK.json``."""
    root = tmp / "checkout"
    bench_dir = root / "benchmark"
    shutil.copytree(BENCH_DIR, bench_dir, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    bench = json.loads((BENCH_DIR.parent / "BENCHMARK.json").read_text())
    configs = [{"name": "toy", "source": "toy", "file": "benchmark/configs/toy.json", "reduced": [], "why": "toy"}]
    (bench_dir / "configs" / "toy.json").write_text(json.dumps(toy_config()))
    workloads = []
    for traffic, sizes in TOY_TRAFFIC.items():
        real = json.loads((BENCH_DIR / "traffic" / f"{traffic}.json").read_text())
        (bench_dir / "traffic" / f"toy_{traffic}.json").write_text(json.dumps(dict(real, **sizes)))
        (bench_dir / "cells" / f"toy.{traffic}.json").write_text(json.dumps({"limits": TOY_LIMITS[traffic]}))
        workloads.append({"name": f"toy.{traffic}", "config": "toy", "traffic": f"toy_{traffic}", "chips": 1,
                          "why": "toy"})
    if distill:
        student = toy_config(expansion_ratio=3)
        student.update(name="toy_distill", teacher_config="toy", distill={"experiment": "toy", "ratio": 0.36})
        (bench_dir / "configs" / "toy_distill.json").write_text(json.dumps(student))
        configs.append({"name": "toy_distill", "source": "toy", "file": "benchmark/configs/toy_distill.json",
                        "reduced": [], "why": "toy"})
        (bench_dir / "cells" / "toy_distill.fit.json").write_text(json.dumps({"limits": TOY_LIMITS["fit"]}))
        workloads.append({"name": "toy_distill.fit", "config": "toy_distill", "traffic": "toy_fit", "chips": 1,
                          "why": "toy"})
    cells = [w["name"] for w in workloads]
    fit_cells = [c for c in cells if c.endswith(".fit")]
    for metric in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in metric:
            kind = metric["workloads"][0].split(".")[0]
            metric["workloads"] = fit_cells if kind == "fit" else [f"toy.{kind}"]
    bench.update(configs=configs, workloads=workloads)
    path = root / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    return path
