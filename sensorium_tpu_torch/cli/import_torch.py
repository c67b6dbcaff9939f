"""Import a checkpoint of the PyTorch reference implementation.

    python -m sensorium_tpu_torch.cli.import_torch IN.pth OUT.ckpt [--dtype float32]

Counterpart of ``sensorium_tpu/cli/import_torch.py``. The reference saves
``{model_name, params, nn_state_dict}`` with its own parameter layout; this
writes a model checkpoint (``engine/checkpoint.py``) of the same weights,
which the port's ``load_model`` / ``Predictor`` and the JAX package's read.
The input is unpickled (``torch.load(weights_only=False)``): convert only
files you trust.
"""

from __future__ import annotations

import argparse
import math
from pathlib import Path

import torch

from sensorium_tpu_torch.compat.torch_weights import convert_torch_state_dict
from sensorium_tpu_torch.engine.checkpoint import save_model_checkpoint
from sensorium_tpu_torch.models.dwiseneuro import padded_group_size


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser(description="Convert a reference .pth checkpoint into a model checkpoint.")
    parser.add_argument("input", type=Path, help="reference .pth checkpoint")
    parser.add_argument("output", type=Path, help="output .ckpt path")
    parser.add_argument(
        "--dtype", default=None, choices=["bfloat16", "float32"],
        help="compute dtype recorded in the converted config (default: the model's, bfloat16)",
    )
    return parser.parse_args(argv)


def convert_checkpoint(input_path: Path, output_path: Path, dtype: str | None = None) -> dict:
    """Convert ``input_path`` into ``output_path``; returns the config written."""
    payload = torch.load(input_path, map_location="cpu", weights_only=False)
    argus_params = payload["params"]
    nn_name, nn_kwargs = argus_params["nn_module"]
    if dtype is not None:
        nn_kwargs = dict(nn_kwargs, dtype=dtype)
        argus_params = dict(argus_params, nn_module=(nn_name, nn_kwargs))
    state_dict = payload["nn_state_dict"]
    groups = nn_kwargs.get("groups", 2)
    params, batch_stats = convert_torch_state_dict(
        state_dict,
        readout_outputs=list(nn_kwargs["readout_outputs"]),
        num_core_blocks=len(nn_kwargs["core_features"]),
        num_cortex_layers=len(nn_kwargs["cortex_features"]),
        groups=groups,
        padded_group_size=padded_group_size(nn_kwargs["readout_outputs"], groups,
                                            nn_kwargs.get("readout_pad_multiple", 128)),
    )
    output_path.parent.mkdir(parents=True, exist_ok=True)
    save_model_checkpoint(output_path, argus_params, {"params": params, "batch_stats": batch_stats})
    total = sum(math.prod(v.shape) for v in state_dict.values())
    print(f"Converted {input_path} ({total / 1e6:.1f}M torch values) -> {output_path}")
    return argus_params


def main(argv=None):
    args = parse_arguments(argv)
    convert_checkpoint(args.input, args.output, dtype=args.dtype)


if __name__ == "__main__":
    main()
