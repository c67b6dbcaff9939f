"""Serving-export CLI: ``python -m sensorium_tpu_torch.cli.export -m CKPT``.

Counterpart of ``sensorium_tpu/cli/export.py``: traces a checkpoint's eval
forward, or its whole-trial program, with ``torch.export`` and writes a
``.pt2`` artifact that loads with torch and the port's ops module alone
(``infer/export.py``). Prints a one-line JSON summary.

Typical flows::

    # all-mice forward for the card and the CPU, written next to the ckpt
    python -m sensorium_tpu_torch.cli.export -m data/experiments/E/fold_0/model-017-0.29.ckpt

    # one mouse's head, custom path, run once on zeros on the card
    python -m sensorium_tpu_torch.cli.export -m CKPT --mouse 1 -o /srv/model.pt2 --check

    # the whole sliding-window trial program (symbolic trial length), traced
    # and checked on the CPU
    python -m sensorium_tpu_torch.cli.export -m CKPT --mouse 1 --trial --check --device cpu

    # the trial program over a 4-way data mesh: one artifact over cards 0-3
    python -m sensorium_tpu_torch.cli.export -m CKPT --mouse 1 --trial --mesh-data 4 --check

The model is loaded, traced and checked on ``--device`` (the card unless
``--device cpu``). ``--mesh-data N`` needs N visible cards; with ``--device
cpu`` N copies of the CPU stand in for them.
"""

from __future__ import annotations

import argparse
import json


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-m", "--model", required=True, help="checkpoint (.ckpt) path")
    parser.add_argument("-o", "--out", default=None, help="artifact output path")
    parser.add_argument(
        "--mouse", default=None,
        help="mouse index for a single-head export (default: all-mice forward)",
    )
    parser.add_argument(
        "--platforms", default="cuda,cpu",
        help="comma-separated devices the artifact may run on (default: cuda,cpu)",
    )
    parser.add_argument(
        "--device", default="cuda",
        help="where the model is loaded, traced and --check'ed: 'cuda' (the default), 'cuda:1' or 'cpu'",
    )
    parser.add_argument(
        "--check", action="store_true",
        help="after writing, load the artifact and run zeros through it on --device",
    )
    parser.add_argument(
        "--trial", action="store_true",
        help="export the whole-trial sliding-window program (requires --mouse) instead of the window forward",
    )
    parser.add_argument(
        "--src-hw", default="36,64",
        help="raw video frame size H,W baked into a --trial artifact (default: the competition's 36,64)",
    )
    parser.add_argument("--chunk", type=int, default=32, help="--trial window-forward chunk size (default 32)")
    parser.add_argument(
        "--bucket", type=int, default=64,
        help="--trial time-axis bucket; the artifact accepts any multiple (default 64; must be a multiple of "
             "--chunk)",
    )
    parser.add_argument(
        "--blend", default="ones", choices=("ones", "linear"), help="--trial overlap blend weights (default ones)",
    )
    parser.add_argument(
        "--mesh-data", type=int, default=0,
        help="export the --trial program as one artifact over an N-way data mesh of cards 0..N-1 (default 0: one "
             "device)",
    )
    return parser.parse_args(argv)


def main(argv=None):
    from sensorium_tpu_torch.infer.export import check_artifact, export_model_file

    args = parse_arguments(argv)
    mouse_index = None
    if args.mouse is not None:
        try:
            mouse_index = int(args.mouse)
        except ValueError:
            raise SystemExit(f"--mouse expects an integer index, got {args.mouse!r}")
    platforms = tuple(p.strip() for p in args.platforms.split(",") if p.strip())
    if not platforms:
        raise SystemExit("--platforms expects at least one target")
    if args.trial and mouse_index is None:
        raise SystemExit("--trial exports one mouse's head: pass --mouse I")
    if args.chunk < 1 or args.bucket < 1:
        raise SystemExit(f"--chunk ({args.chunk}) and --bucket ({args.bucket}) must be positive")
    if args.bucket % args.chunk:
        raise SystemExit(f"--bucket ({args.bucket}) must be a multiple of --chunk ({args.chunk})")
    if args.mesh_data and not args.trial:
        raise SystemExit("--mesh-data applies to --trial exports only")
    if args.mesh_data and args.mesh_data < 2:
        raise SystemExit(
            f"--mesh-data expects an integer >= 2 (a data axis of {args.mesh_data} devices cannot shard anything)"
        )
    if args.mesh_data and args.chunk % args.mesh_data:
        raise SystemExit(f"--chunk ({args.chunk}) must be a multiple of --mesh-data ({args.mesh_data})")
    try:
        src_hw = tuple(int(v) for v in args.src_hw.split(","))
        if len(src_hw) != 2:
            raise ValueError
    except ValueError:
        raise SystemExit(f"--src-hw expects H,W integers, got {args.src_hw!r}")

    summary = export_model_file(
        args.model,
        out_path=args.out,
        mouse_index=mouse_index,
        platforms=platforms,
        trial=args.trial,
        src_hw=src_hw,
        chunk_size=args.chunk,
        length_bucket=args.bucket,
        blend_weights=args.blend,
        mesh_data=args.mesh_data,
        device=args.device,
    )
    if args.check:
        summary["check"] = check_artifact(summary["artifact"], device=args.device)
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
