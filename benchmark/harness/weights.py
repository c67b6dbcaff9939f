"""Model weights made by the benchmark from the seed, handed to the program
and to the reference alike.

All draws come from one ``torch.Generator`` on the run's device in two large
calls (one normal, one uniform draw over every tensor at once), in float32,
the type the parameters are kept in; each tensor is then a scaled slice.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.harness.synth import Draws, sub_seed, trial_arrays
from benchmark.reference import data as ref_data
from benchmark.reference import model as ref


def make_weights(cfg: dict, seed: int, device, stream: str = "weights") -> dict[str, torch.Tensor]:
    """``{name: tensor}`` of every parameter and BN statistic of the model
    ``cfg`` describes, as ``reference.model.param_specs`` lays them out."""
    specs = ref.param_specs(cfg)
    normal = sum(int(np.prod(shape)) for _, shape, init, _ in specs if init[0] in ("normal", "readout"))
    uniform = sum(int(np.prod(shape)) for _, shape, init, _ in specs if init[0] == "uniform")
    generator = torch.Generator(device=device).manual_seed(sub_seed(seed, stream))
    normal_draws = torch.randn(normal, generator=generator, device=device)
    uniform_draws = torch.rand(uniform, generator=generator, device=device)
    stds = ref.readout_stds(cfg)
    out, n_at, u_at = {}, 0, 0
    for name, shape, init, _ in specs:
        size = int(np.prod(shape))
        if init[0] == "uniform":
            low, high = init[1], init[2]
            out[name] = (uniform_draws[u_at:u_at + size] * (high - low) + low).view(shape)
            u_at += size
            continue
        draws = normal_draws[n_at:n_at + size].view(shape)
        n_at += size
        if init[0] == "readout":
            out[name] = draws * torch.tensor(stds, device=device).view(-1, *([1] * (len(shape) - 1)))
        else:
            out[name] = draws * init[1]
    return out


@torch.no_grad()
def calibrate_bn(weights: dict, cfg: dict, frame_stack: dict, canvas, video_shape, seed: int, device,
                 windows: int = 16) -> dict:
    """The weights with every BN's running statistics set to the batch
    statistics of its input over ``windows`` windows of a trial drawn from
    the seed, as a trained model's statistics fit its activations: the
    reference's training-mode forward (no masks) gives them all in one pass,
    and eval mode then normalizes those windows as training mode did."""
    size, step = frame_stack["size"], frame_stack["step"]
    length = (size - 1) * step + windows
    video, behavior, pupil = trial_arrays(Draws(seed, "bn_statistics", device), video_shape, length)
    stack = ref_data.stack_inputs(video, behavior, pupil, np.arange(length), canvas)
    frames = np.stack([ref_data.window_frames(a, size, step) for a in range(length - windows, length)])
    batch = torch.from_numpy(stack[:, frames]).permute(1, 0, 2, 3, 4).to(device)
    stats: dict = {}
    ref.forward(weights, batch, cfg, mouse=0, train=True, masks=ref.Masks(), stats=stats)
    out = dict(weights)
    for prefix, (mean, var, _) in stats.items():
        out[f"{prefix}.bn.mean"], out[f"{prefix}.bn.var"] = mean.clone(), var.clone()
    return out
