"""The port's ``tools/make_synth_data.py`` writes the JAX tool's tree byte for byte."""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

from sensorium_tpu_torch.tools import make_synth_data

REPO = Path(__file__).resolve().parents[1]
ARGS = ["--trial-length", "40", "--trials", "7"]


def files(root: Path) -> dict[str, bytes]:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*")) if p.is_file()}


def test_tree_is_the_jax_tools_byte_for_byte(tmp_path):
    jax_root, port_root = tmp_path / "jax", tmp_path / "port"
    proc = subprocess.run([sys.executable, str(REPO / "tools" / "make_synth_data.py"), str(jax_root), *ARGS],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    make_synth_data.main([str(port_root), *ARGS])
    expected, got = files(jax_root), files(port_root)
    # Per mouse 4 meta files and 7 labeled trials of 4 files; a new mouse also 2 unlabeled trials of 3.
    assert len(expected) == 10 * 4 + 10 * 7 * 4 + 5 * 2 * 3
    assert got.keys() == expected.keys()
    for name, data in expected.items():
        assert got[name] == data, name


def test_cli_runs_as_a_module(tmp_path):
    proc = subprocess.run([sys.executable, "-m", "sensorium_tpu_torch.tools.make_synth_data", str(tmp_path),
                           "--trial-length", "31", "--trials", "7", "--seed", "1"],
                          cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "Synthetic dataset written to" in proc.stdout
    tiers = (tmp_path / "sensorium_all_2023").glob("*/meta/trials/tiers.npy")
    assert len(list(tiers)) == 10
