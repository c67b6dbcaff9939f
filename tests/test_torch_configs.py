"""The port's experiment configs and metric registry against the JAX package's.

Each config of ``sensorium_tpu_torch/configs`` must be the JAX file of the
same name (``configs/``), value for value, apart from
``argus_params["device"]``, which names the card. Both are loaded as the
CLIs load them, with ``SourceFileLoader``. A subprocess shows that the
port's configs and ``cli.train`` leave JAX and the JAX package unimported.
"""

from __future__ import annotations

import json
import subprocess
import sys
from importlib.machinery import SourceFileLoader
from pathlib import Path

import pytest

from sensorium_tpu.engine.metrics import CorrelationMetric as JCorrelationMetric
from sensorium_tpu.engine.metrics import get_metric as jget_metric
from sensorium_tpu_torch import constants
from sensorium_tpu_torch.engine.metrics import CorrelationMetric, get_metric

REPO = Path(__file__).resolve().parents[1]
CONFIGS = ("true_batch_001", "distillation_001", "smoke_001")


def load_config(directory: Path, name: str) -> dict:
    return SourceFileLoader(name, str(directory / f"{name}.py")).load_module().config


@pytest.mark.parametrize("name", CONFIGS)
def test_config_equals_the_jax_file_apart_from_the_device(name):
    port = load_config(REPO / "sensorium_tpu_torch" / "configs", name)
    jax_config = load_config(REPO / "configs", name)
    assert port["argus_params"].pop("device") == "cuda"
    assert jax_config["argus_params"].pop("device") == "tpu"
    assert port == jax_config


def test_configs_dir_defaults_to_the_port_configs():
    assert sorted(p.stem for p in constants.configs_dir.glob("*.py")) == sorted(CONFIGS)
    assert constants.configs_dir == REPO / "sensorium_tpu_torch" / "configs"


def test_smoke_config_cuts_only_the_epochs():
    smoke = load_config(constants.configs_dir, "smoke_001")
    base = load_config(constants.configs_dir, "true_batch_001")
    assert (smoke.pop("train_epoch_size"), smoke.pop("num_epochs")) == (64, [1, 1])
    assert {k: v for k, v in base.items() if k not in ("train_epoch_size", "num_epochs")} == smoke


CHECK_IMPORTS = """
import json, sys
from importlib.machinery import SourceFileLoader
from pathlib import Path
from sensorium_tpu_torch import constants
from sensorium_tpu_torch.cli import train
for name in ("true_batch_001", "distillation_001", "smoke_001"):
    SourceFileLoader(name, str(constants.configs_dir / f"{name}.py")).load_module()
try:
    train.main(["--help"])
except SystemExit as exit_info:
    code = exit_info.code
print(json.dumps({"code": code, "bad": sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "msgpack", "sensorium_tpu"))}))
"""


def test_configs_and_train_cli_import_no_jax():
    proc = subprocess.run([sys.executable, "-c", CHECK_IMPORTS], cwd=REPO, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "-e EXPERIMENT" in proc.stdout and "--device DEVICE" in proc.stdout
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result == {"code": 0, "bad": []}


def test_get_metric_builds_the_correlation_metric_as_jax_does():
    metric, jmetric = get_metric("corr", num_neurons=[3, 4]), jget_metric("corr", num_neurons=[3, 4])
    assert isinstance(metric, CorrelationMetric) and isinstance(jmetric, JCorrelationMetric)
    assert metric.num_neurons == jmetric.num_neurons == [3, 4]
    assert get_metric("corr").num_neurons == constants.num_neurons
    with pytest.raises(KeyError) as error:
        get_metric("mse")
    with pytest.raises(KeyError) as jerror:
        jget_metric("mse")
    assert str(error.value) == str(jerror.value) == "\"Unknown metric 'mse'\""
