"""Boundaries of the PyTorch/CUDA port: what it imports, and where it runs.

The port (``sensorium_tpu_torch``) and ``chip_smoke.py`` import neither JAX
nor anything of the JAX package, and every entry point runs on the card
unless the caller asks for the CPU.
"""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from sensorium_tpu_torch.engine.model import MouseModel, load_model
from sensorium_tpu_torch.infer.predictor import Predictor
from sensorium_tpu_torch.models.registry import get_nn_module
from tests.test_engine import tiny_params

REPO = Path(__file__).resolve().parents[1]

IMPORT_EVERYTHING = """
import importlib, json, pkgutil, sys
import sensorium_tpu_torch
names = [m.name for m in pkgutil.walk_packages(sensorium_tpu_torch.__path__, "sensorium_tpu_torch.")]
for name in names:
    importlib.import_module(name)
import chip_smoke
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "msgpack", "orbax", "sensorium_tpu"))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    proc = subprocess.run(
        [sys.executable, "-c", IMPORT_EVERYTHING], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    # The port's own name starts with "sensorium_tpu": match the package, not the prefix.
    assert result["bad"] == []
    assert "sensorium_tpu_torch.infer.predictor" in result["modules"]
    assert "sensorium_tpu_torch.ops.dw_kernels" in result["modules"]
    assert "sensorium_tpu_torch.engine.steps" in result["modules"]
    assert "sensorium_tpu_torch.engine.model" in result["modules"]
    for name in ("tools.dwbench", "data.loader", "data.native", "engine.callbacks", "engine.checkpoint",
                 "utils.msgpack", "infer.submission", "cli.predict", "cli.import_torch", "cli.train",
                 "cli.download_data", "utils.profiling", "infer.export", "cli.export", "parallel.mesh",
                 "parallel.tensor", "parallel.multihost", "tools.bench", "tools.make_synth_data", "ops.conv"):
        assert f"sensorium_tpu_torch.{name}" in result["modules"]


def test_training_engine_imports_no_jax():
    """The train step and MouseModel alone pull in neither JAX nor the JAX package."""
    code = (
        "import json, sys\n"
        "import sensorium_tpu_torch.engine.steps, sensorium_tpu_torch.engine.model\n"
        "print(json.dumps(sorted(m for m in sys.modules "
        "if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'msgpack', 'orbax', 'sensorium_tpu'))))"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_serving_export_imports_no_jax():
    """The export module and its CLI alone pull in neither JAX nor the JAX
    package; the export module imports no model or engine code until it exports."""
    code = (
        "import json, sys\n"
        "import sensorium_tpu_torch.infer.export, sensorium_tpu_torch.cli.export\n"
        "print(json.dumps({'jax': sorted(m for m in sys.modules "
        "if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'optax', 'msgpack', 'orbax', 'sensorium_tpu')), "
        "'model': sorted(m for m in sys.modules "
        "if m.startswith(('sensorium_tpu_torch.models', 'sensorium_tpu_torch.engine')))}))"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == {"jax": [], "model": []}


SHARDED_STATE_ROUND_TRIP = """
import json, sys, tempfile
from pathlib import Path
from sensorium_tpu_torch.engine.model import MouseModel
params = {"nn_module": ("dwiseneuro", {"readout_outputs": [5, 7], "core_features": (8, 8), "spatial_strides": (2, 2),
          "expansion_ratio": 2, "se_reduce_ratio": 4, "cortex_features": (16, 16), "dtype": "float32",
          "readout_pad_multiple": 8, "drop_rate": 0.0, "drop_path_rate": 0.0})}
with tempfile.TemporaryDirectory() as work:
    for seed in (0, 1):
        model = MouseModel(params, device="cpu")
        model.build_state(seed=seed)
        if seed == 0:
            model.save_train_state(Path(work) / "state.orbax", extra={"epoch": 3})
    assert model.load_train_state(Path(work) / "state.orbax") == {"epoch": 3}
print(json.dumps(sorted(m for m in sys.modules
                        if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "msgpack", "orbax", "sensorium_tpu"))))
"""


def test_sharded_train_state_imports_no_jax_nor_orbax():
    """A ``.orbax`` train state saved and loaded by the port pulls in neither
    JAX, orbax nor the JAX package (``torch.distributed.checkpoint`` writes it)."""
    proc = subprocess.run([sys.executable, "-c", SHARDED_STATE_ROUND_TRIP], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_data_feed_imports_neither_pillow_nor_scipy():
    """Only the pHash fold assignment needs them, and it imports them when it hashes."""
    code = (
        "import json, sys\n"
        "import sensorium_tpu_torch.data.mouse_data, sensorium_tpu_torch.data.loader\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in ('PIL', 'scipy'))))"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


def test_dwbench_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    from sensorium_tpu_torch.tools import dwbench

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        dwbench.main([])


def test_entry_points_refuse_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    name, params = tiny_params()["nn_module"]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        get_nn_module(name, params)
    model = get_nn_module(name, params, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Predictor.from_module(model, tiny_params())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        MouseModel(tiny_params())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Predictor("model-000-0.000000.ckpt")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_model("model-000-0.000000.ckpt")
    from sensorium_tpu_torch.infer.export import check_artifact, load_exported

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_exported("model.pt2")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        check_artifact("model.pt2")


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    """No card, or no repo beside the script: a non-zero exit and no result line."""
    if torch.cuda.is_available() and not alone:
        pytest.skip("this machine has a CUDA card")
    script = REPO / "chip_smoke.py"
    cwd = REPO
    if alone:
        shutil.copy(script, tmp_path / "chip_smoke.py")
        script, cwd = tmp_path / "chip_smoke.py", tmp_path
    proc = subprocess.run([sys.executable, str(script)], cwd=cwd, capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout
