"""The work arithmetic: the depthwise bounds of the kernel table (a
flagship train step, batch 32 x 16 frames, summed over the 9 blocks' calls)
and the FLOP counts that the utilization metrics divide."""

from __future__ import annotations

import json

import pytest

from benchmark.harness import spec
from benchmark.work import counts

H100 = counts.PEAKS["cards"]["H100"]


def nn(name):
    return spec.load_config(name)["argus_params"]["nn_module"][1]


@pytest.mark.parametrize("kernel, bound_ms", [
    ("dw_spatial_fwd", 2.419), ("dw_spatial_dx", 2.419), ("dw_spatial_dw", 2.419),
    ("dw_temporal_fwd", 1.683), ("dw_temporal_dw", 1.683), ("dw_temporal_dx", 1.683)])
def test_depthwise_bounds_of_the_kernel_table(kernel, bound_ms):
    calls = [c for c in counts.dw_calls(nn("true_batch_001"), 32, 16, 64, 64, backward=True) if c["kernel"] == kernel]
    assert len(calls) == 9
    assert 1e3 * counts.least_seconds(calls, H100) == pytest.approx(bound_ms, abs=5e-4)


def test_flop_counts_of_the_configurations():
    tb, distill = nn("true_batch_001"), nn("distillation_001")
    # The hand count: expand at the block's input resolution, taps and
    # project at its output's, SE, cortex, readouts (78,853 neurons).
    assert counts.forward_flops(tb, 1, 16, 64, 64) == 33_862_148_096
    assert counts.forward_flops(tb, 1, 16, 64, 64, mouse=7) == 29_237_403_648
    assert counts.mean_eval_flops_per_window(tb, 16, 64, 64) == pytest.approx(29_211_208_908.8)
    assert counts.train_flops_per_clip(tb, 16, 64, 64) == 3 * 33_862_148_096
    assert counts.train_flops_per_clip(distill, 16, 64, 64, teacher=tb) == pytest.approx(123_242_209_280)


def test_chunks_and_windows():
    stack = {"size": 16, "step": 2}
    assert counts.chunk_sizes(300, stack, 32) == [32] * 8 + [14]
    assert counts.windows(31, stack) == 1 and counts.windows(62, stack) == 32 and counts.windows(30, stack) == 0
    assert counts.peaks_for("NVIDIA H100 80GB HBM3") == H100 and counts.peaks_for("cpu") is None
    assert json.dumps(counts.PEAKS)
