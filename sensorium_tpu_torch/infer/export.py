"""Ahead-of-time serving export of trained models (``torch.export``).

Counterpart of ``sensorium_tpu/infer/export.py``. The eval forward, or the
whole sliding-window trial program, is traced once with ``torch.export``,
with the eval (EMA) weights inside it, and saved as a ``.pt2`` artifact.
The depthwise convs appear in the graph as the custom ops
``sensorium::dw_spatial_fwd_bn`` and ``sensorium::dw_temporal_fwd_bn``
(``ops/dw_kernels.py``), which carry each block's ``pw_bn`` and
``spatial_bn`` as their prologue, every other BN with its SiLU as
``sensorium::bn_act_eval`` (``ops/bn_kernels.py``); importing this module
registers them all for a loader.

Properties of the artifact:

* loading it needs torch and the port's ops module only: no model code,
  checkpoint or config (``load_exported(path)(*inputs)``);
* the batch of the window forward and the trial length of the trial program
  are symbolic, so one artifact serves every batch size and every multiple
  of the length bucket;
* ``platforms`` lists the devices it may run on, ``cuda`` and ``cpu``:
  ``load_exported`` moves a program traced on one to the other
  (``torch.export.passes.move_to_device_pass``), as JAX's artifact carries
  one lowering for each platform.

The trial program of a ``Predictor(mesh=)`` (``mesh_data`` N: a data mesh
of N devices) is one multi-device artifact: each chunk's windows are split
over the replicas, one a data index, each over its model group's cards
with the cortex and readout weights sliced across them (the live
``replica_forwards``); the blend's accumulators stay on the first card.
Its weights are stored once, those of the first replica: the program
copies them to the other replicas' cards at the start of each call and
runs each replica with ``torch.func.functional_call``. The metadata names
the mesh, ``nr_devices`` (replica x data x model) and the distinct devices
it was traced on; ``load_exported`` maps those onto the serving host's
cards (``move_to_device_pass`` with a mapping) and raises when fewer are
visible. Traced on the CPU, N copies of ``cpu`` stand in for N devices, so
such an artifact runs on one card.

This module imports the model, the engine and the predictor only inside the
functions that export; loading and checking an artifact import none of them.
"""

from __future__ import annotations

import functools
import io
import json
import os
from pathlib import Path

import torch
from torch.export.passes import move_to_device_pass

import sensorium_tpu_torch.ops.bn_kernels  # noqa: F401  (registers the sensorium:: ops that artifacts call)
import sensorium_tpu_torch.ops.dw_kernels  # noqa: F401

EXPORT_SUFFIX = ".pt2"
PLATFORMS = ("cuda", "cpu")
_META = "sensorium.json"  # the artifact's extra file: its platforms, mesh and trace devices


def _check_platforms(platforms) -> tuple[str, ...]:
    platforms = tuple(platforms)
    if not platforms or any(p not in PLATFORMS for p in platforms):
        raise ValueError(f"platforms must be a non-empty subset of {PLATFORMS}, got {platforms}")
    return platforms


def _frozen(nn_module: torch.nn.Module, frames: int, height: int, width: int) -> torch.nn.Module:
    """A copy of an eval module whose weights do not require grad, holding
    the position encodings of (frames, height, width) inputs as buffers."""
    import copy

    frozen = copy.deepcopy(nn_module).eval().requires_grad_(False)
    frozen.hold_position_encodings(frames, height, width)
    return frozen


class _Forward(torch.nn.Module):
    def __init__(self, nn_module: torch.nn.Module, mouse_index: int | None):
        super().__init__()
        self.model = nn_module
        self.mouse_index = mouse_index

    def forward(self, inputs: torch.Tensor) -> torch.Tensor:
        return self.model(inputs, mouse_index=self.mouse_index).float()


class _Exported:
    """A traced program, its platforms and the devices it was traced on (in
    mesh order; a mesh's shape, or None), before it is saved."""

    def __init__(self, program: torch.export.ExportedProgram, platforms: tuple[str, ...], devices,
                 mesh_shape: dict | None = None):
        self.program = program
        self.platforms = platforms
        self.devices = tuple(torch.device(d) for d in devices)
        self.mesh_shape = mesh_shape

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    @property
    def nr_devices(self) -> int:
        return len(self.devices)


def export_forward(
    model,
    mouse_index: int | None = None,
    frames: int | None = None,
    height: int | None = None,
    width: int | None = None,
    platforms: tuple[str, ...] = PLATFORMS,
) -> _Exported:
    """Trace the eval-mode forward of a ``MouseModel`` on its device.

    ``mouse_index=None`` exports the all-mice forward ``(b, C, T, H, W) ->
    (M, b, N_max, T)``; an int exports that mouse's head ``(b, C, T, H, W)
    -> (b, N_m, T)``, fp32 either way. The batch ``b`` is symbolic.
    ``frames``/``height``/``width`` default to the config's frame-stack size
    and input-processor canvas. ``save_exported`` writes the result.
    """
    platforms = _check_platforms(platforms)
    nn_module = model.state.eval_model
    if frames is None:
        frames = int(model.params["frame_stack"]["size"])
    if height is None or width is None:
        proc_kwargs = model.params["inputs_processor"][1]
        # StackInputsProcessor's size is (width, height).
        canvas_w, canvas_h = proc_kwargs["size"]
        height = height if height is not None else int(canvas_h)
        width = width if width is not None else int(canvas_w)
    channels = nn_module.stem_kernel.shape[0]
    # An example batch of 2: export specialises a dimension it sees at 1.
    example = torch.zeros((2, channels, frames, height, width), dtype=torch.float32, device=model.device)
    batch = torch.export.Dim("b", min=1)
    with torch.no_grad():
        program = torch.export.export(
            _Forward(_frozen(nn_module, frames, height, width), mouse_index), (example,), dynamic_shapes=({0: batch},)
        )
    _check_symbolic(program, [(0, 0)])
    return _Exported(program, platforms, [model.device])


def _call_with(module: torch.nn.Module, weights: dict, batch: torch.Tensor, mouse_index: int) -> torch.Tensor:
    return torch.func.functional_call(module, weights, (batch,), {"mouse_index": mouse_index})


class _TrialProgram(torch.nn.Module):
    """Whole-trial inference over a time axis padded to a multiple of the
    bucket (see ``export_trial``). ``placements``: for each replica after
    the first, the device of each of the first replica's parameters and
    buffers there; ``devices``: each replica's first card."""

    def __init__(self, predictor, nn_module: torch.nn.Module, mouse_index: int, placements: list[dict],
                 devices: list[torch.device]):
        super().__init__()
        gen = predictor.indexes_generator
        proc = predictor.inputs_processor
        self.model = nn_module
        self.placements = placements
        self.devices = devices
        self.mouse_index = mouse_index
        self.chunk = predictor.chunk_size
        self.behind, self.ahead, self.step, self.size = gen.behind, gen.ahead, gen.step, gen.size
        self.width, self.height = proc.size
        self.fill = proc.pad_fill_value
        self.num_neurons = nn_module.readout_outputs[mouse_index]
        self.register_buffer("blend_weights", predictor.blend_weights.clone())

    def forward(self, video, behavior, pupil_center, length):
        from torch._higher_order_ops import scan

        from sensorium_tpu_torch.infer.predictor import assemble_trial_stack, chunk_updates

        padded_len = video.shape[0]
        device = video.device
        trial_inputs = assemble_trial_stack(video, behavior, pupil_center, self.height, self.width, self.fill)
        # The other replicas' weights: the stored ones, copied to their cards once a call.
        weights = {**dict(self.model.named_parameters()), **dict(self.model.named_buffers())}
        models = [self.model] + [
            functools.partial(_call_with, self.model, {name: t.to(placement[name]) for name, t in weights.items()})
            for placement in self.placements]
        replica_inputs = [trial_inputs.to(d) for d in self.devices]
        # One anchor per padded frame; rows past the true anchor range carry
        # zero weight, as in JAX's trial program.
        anchors = self.behind + torch.arange(padded_len, device=device)
        valid = (anchors < length - self.ahead).float()
        offsets = torch.arange(-self.behind, self.ahead + 1, self.step, device=device)
        windows = (anchors[:, None] + offsets[None, :]).clamp(0, padded_len - 1)
        windows = windows.reshape(-1, self.chunk, self.size)
        valid = valid.reshape(-1, self.chunk)

        def body(carry, chunk):
            resp_acc, blend_acc = carry
            flat, resp, blend = chunk_updates(
                models, replica_inputs, chunk[0], self.blend_weights, self.mouse_index, chunk[1]
            )
            return (resp_acc.index_add(1, flat, resp), blend_acc.index_add(0, flat, blend)), flat.new_zeros(())

        init = (
            torch.zeros((self.num_neurons, padded_len), dtype=torch.float32, device=device),
            torch.zeros((padded_len,), dtype=torch.float32, device=device),
        )
        (resp_acc, blend_acc), _ = scan(body, init, (windows, valid))
        return resp_acc / blend_acc.clamp(min=1.0)


def export_trial(
    predictor,
    mouse_index: int,
    src_hw: tuple[int, int] = (36, 64),
    platforms: tuple[str, ...] = PLATFORMS,
) -> _Exported:
    """Trace whole-trial sliding-window inference of a ``Predictor``.

    The program assembles the 5-channel stack on the device, gathers the
    stride-1 windows of every anchor, runs them ``chunk_size`` at a time
    through ``torch._higher_order_ops.scan`` (``chunk_updates``, the live
    predictor's chunk step) and divides the overlap blend by the clamped
    blend weights. Its signature::

        (video (Tp, sh, sw) f32, behavior (2, Tp) f32,
         pupil_center (2, Tp) f32, length () i32) -> (N, Tp) f32

    where ``Tp = length_bucket * k`` for any k >= 1 and ``length <= Tp`` is
    the true trial length: callers zero-pad the time axis and slice the
    result to ``[:, :length]``. ``src_hw`` fixes the raw frame size, centred
    on the canvas like ``StackInputsProcessor``. A ``Predictor(mesh=)``
    gives the multi-device program (module docstring): the inputs on the
    first card, the chunk's windows split over the replicas.
    """
    platforms = _check_platforms(platforms)
    chunk, bucket = predictor.chunk_size, predictor.length_bucket
    if chunk < 1 or bucket < 1:
        raise ValueError(f"chunk_size ({chunk}) and length_bucket ({bucket}) must be positive")
    if bucket % chunk:
        raise ValueError(
            f"length_bucket {bucket} must be a multiple of chunk_size {chunk} for a symbolic-length export"
        )
    width, height = predictor.inputs_processor.size
    src_h, src_w = src_hw
    if src_h > height or src_w > width:
        raise ValueError(f"src_hw {src_hw} exceeds the model canvas ({height}x{width})")
    frozen = _frozen(predictor.model, predictor.indexes_generator.size, height, width)
    program = _TrialProgram(predictor, frozen, mouse_index, _placements(frozen, predictor.replicas[1:]),
                            [device for _, device in predictor.replicas])
    device = predictor.device
    # Two buckets: export specialises a dimension it sees at 1.
    padded = 2 * bucket
    example = (
        torch.zeros((padded, src_h, src_w), dtype=torch.float32, device=device),
        torch.zeros((2, padded), dtype=torch.float32, device=device),
        torch.zeros((2, padded), dtype=torch.float32, device=device),
        torch.tensor(padded, dtype=torch.int32, device=device),
    )
    k = torch.export.Dim("k", min=1)
    time = bucket * k
    with torch.no_grad():
        exported = torch.export.export(
            program, example, dynamic_shapes=({0: time}, {1: time}, {1: time}, None)
        )
    _check_symbolic(exported, [(0, 0), (1, 1), (2, 1)])
    mesh = predictor.mesh
    if mesh is None:
        return _Exported(exported, platforms, [device])
    return _Exported(exported, platforms, mesh.devices, dict(mesh.shape))


def _placements(frozen: torch.nn.Module, replicas: list) -> list[dict]:
    """For each ``(module, first card)`` of ``replicas``, where each of
    ``frozen``'s parameters and buffers lies in it (a buffer only the frozen
    copy holds, a position encoding, on the replica's first card)."""
    out = []
    for module, device in replicas:
        held = {name: t.device for name, t in [*module.named_parameters(), *module.named_buffers()]}
        out.append({name: held.get(name, device) for name, _ in [*frozen.named_parameters(), *frozen.named_buffers()]})
    return out


def _input_values(program: torch.export.ExportedProgram) -> list:
    """The fake values of the program's user inputs, in order."""
    names = set(program.graph_signature.user_inputs)
    return [node.meta["val"] for node in program.graph.nodes if node.op == "placeholder" and node.target in names]


def _check_symbolic(program: torch.export.ExportedProgram, dims: list[tuple[int, int]]) -> None:
    """Raise if export made any (input, dim) of ``dims`` a constant."""
    values = _input_values(program)
    for index, dim in dims:
        if isinstance(values[index].shape[dim], int):
            raise RuntimeError(f"export specialised dim {dim} of input {index} to {values[index].shape[dim]}")


def save_exported(path: Path | str, exported: _Exported) -> Path:
    """Atomic write of an artifact: a ``.tmp`` file, then a rename."""
    path = Path(path)
    buffer = io.BytesIO()
    meta = {"platforms": list(exported.platforms), "traced_on": exported.device.type,
            "nr_devices": exported.nr_devices, "mesh": exported.mesh_shape,
            "devices": list(dict.fromkeys(str(d) for d in exported.devices))}
    torch.export.save(exported.program, buffer, extra_files={_META: json.dumps(meta)})
    tmp = path.with_name(path.name + ".tmp")
    tmp.write_bytes(buffer.getvalue())
    os.replace(tmp, path)
    return path


def _read(path: Path | str) -> tuple[torch.export.ExportedProgram, dict]:
    extra = {_META: ""}
    program = torch.export.load(Path(path), extra_files=extra)
    return program, json.loads(extra[_META])


def _placement(traced: list[str], device: torch.device) -> str | dict[str, str]:
    """Where ``move_to_device_pass`` puts the artifact traced on the
    ``traced`` devices: a one-device artifact wholly on ``device`` (its
    graph may name "cuda:0" where it was traced on "cuda"); a multi-device
    one as a mapping onto the CPU, or onto cards 0 to n-1 (``device`` a card
    type without an index)."""
    if len(traced) == 1:
        return str(device)
    if device.type == "cpu":
        return {name: str(device) for name in traced}
    if device.index is not None:
        raise ValueError(f"the artifact runs on {len(traced)} cards {traced}: pass 'cuda', not {device}")
    visible = torch.cuda.device_count()
    if visible < len(traced):
        raise ValueError(f"the artifact was exported for {len(traced)} cards {traced}; only {visible} "
                         "are visible on this host")
    return {name: f"cuda:{i}" for i, name in enumerate(traced)}


def _load(path: Path | str, device: str | torch.device) -> tuple[torch.export.ExportedProgram, torch.device, dict]:
    from sensorium_tpu_torch.utils.device import resolve_device

    device = resolve_device(device)
    program, meta = _read(path)
    if device.type not in meta["platforms"]:
        raise ValueError(f"the artifact runs on {meta['platforms']}, not on {device.type}")
    placement = _placement(meta.get("devices", [meta["traced_on"]]), device)
    first = torch.device(placement if isinstance(placement, str) else next(iter(placement.values())))
    return move_to_device_pass(program, placement), first, meta


def load_exported(path: Path | str, device: str | torch.device = "cuda") -> torch.nn.Module:
    """An artifact as a callable module on ``device`` (moved there if it was
    traced on the other device). A multi-device artifact's devices are
    mapped onto cards 0 to n-1 (``device`` "cuda") or onto the CPU; its
    inputs go to the first. The module's ``nr_devices`` and ``mesh`` are
    the artifact's. Raises if the device is not in the artifact's
    platforms, names CUDA and there is no card, names one card for a
    multi-device artifact, or fewer cards are visible than it needs."""
    program, _, meta = _load(path, device)
    module = program.module()
    module.nr_devices, module.mesh = meta.get("nr_devices", 1), meta.get("mesh")
    return module


def export_model_file(
    model_path: Path | str,
    out_path: Path | str | None = None,
    mouse_index: int | None = None,
    platforms: tuple[str, ...] = PLATFORMS,
    trial: bool = False,
    src_hw: tuple[int, int] = (36, 64),
    chunk_size: int = 32,
    length_bucket: int = 64,
    blend_weights: str = "ones",
    mesh_data: int = 0,
    device: str | torch.device = "cuda",
) -> dict:
    """Checkpoint file -> serving artifact file. Returns a summary dict.

    ``trial=False`` exports the window forward (:func:`export_forward`);
    ``trial=True`` the whole-trial program (:func:`export_trial`, which
    needs ``mouse_index``). The model is loaded and traced on ``device``.
    ``mesh_data`` 0 gives a single-device artifact; ``mesh_data >= 2`` a
    multi-device trial artifact over an N-way data mesh: cards 0 to N-1
    (fewer visible raises ``ValueError``), or N copies of the CPU with
    ``device="cpu"``; 1 and negatives raise ``ValueError``.
    """
    model_path = Path(model_path)
    if mesh_data < 0 or mesh_data == 1:
        raise ValueError(f"mesh_data must be 0 (no mesh) or >= 2, got {mesh_data}")
    if mesh_data > 1 and not trial:
        raise ValueError("mesh_data applies to trial exports only (trial=True); the window-forward artifact is "
                         "single-device")
    mesh = _data_mesh(mesh_data, device) if mesh_data else None
    if trial:
        if mouse_index is None:
            raise ValueError("trial export requires a mouse_index")
        from sensorium_tpu_torch.infer.predictor import Predictor

        predictor = Predictor(model_path, blend_weights=blend_weights, chunk_size=chunk_size,
                              length_bucket=length_bucket, device=device, mesh=mesh)
        exported = export_trial(predictor, mouse_index, src_hw=src_hw, platforms=platforms)
        kind = f".mouse{mouse_index}.trial"
    else:
        from sensorium_tpu_torch.engine.model import load_model

        exported = export_forward(load_model(model_path, device=device), mouse_index=mouse_index,
                                  platforms=platforms)
        kind = "" if mouse_index is None else f".mouse{mouse_index}"
    if out_path is None:
        out_path = model_path.with_suffix(kind + EXPORT_SUFFIX)
    save_exported(out_path, exported)
    program = exported.program
    return {
        "artifact": str(out_path),
        "bytes": Path(out_path).stat().st_size,
        "platforms": list(exported.platforms),
        "mouse_index": mouse_index,
        "trial": trial,
        "nr_devices": exported.nr_devices,
        "mesh": exported.mesh_shape,
        "input_shapes": [[str(d) for d in v.shape] for v in _input_values(program)],
        "output_shape": [str(d) for d in _output_values(program)[0].shape],
    }


def _data_mesh(count: int, device: str | torch.device):
    """A ``count``-way data mesh: cards 0 to count-1, or count copies of the CPU."""
    from sensorium_tpu_torch.parallel.mesh import create_mesh

    if torch.device(device).type == "cpu":
        return create_mesh(num_data=count, devices=["cpu"] * count)
    visible = torch.cuda.device_count()
    if visible < count:
        raise ValueError(f"mesh_data={count} needs {count} local devices to trace the sharded program; only "
                         f"{visible} are visible on this host")
    return create_mesh(num_data=count, devices=[f"cuda:{i}" for i in range(count)])


def _output_values(program: torch.export.ExportedProgram) -> list:
    (output,) = [node for node in program.graph.nodes if node.op == "output"]
    return [arg.meta["val"] for arg in output.args[0]]


def _resolve_dim(dim, value: int, ranges: dict) -> int:
    """A concrete dimension: an int stays, every symbol of a symbolic one
    (``b``, ``64*k``, ...) becomes ``value``; the size must lie in the
    dimension's range (the program's ``range_constraints``)."""
    if isinstance(dim, int):
        return dim
    expr = dim.node.expr
    size = int(expr.subs({symbol: value for symbol in expr.free_symbols}))
    bounds = ranges.get(expr)
    if bounds is not None and not bounds.lower <= size <= bounds.upper:
        raise ValueError(f"{size} is outside the range [{bounds.lower}, {bounds.upper}] of the dimension {expr}")
    return size


def check_artifact(path: Path | str, batch: int = 1, device: str | torch.device = "cuda") -> dict:
    """Run an artifact on ``device`` with zeros and return output stats.

    The window forward gets a batch of ``batch``; the trial program
    ``batch`` buckets, with the length set to the padded time axis. The
    symbolic dimensions are the program's (``range_constraints``).
    """
    program, device, _ = _load(path, device)
    args = []
    lead_dim = None
    for value in _input_values(program):
        shape = tuple(_resolve_dim(d, batch, program.range_constraints) for d in value.shape)
        if shape == () and not value.dtype.is_floating_point:
            # The trial program's true length: the padded time axis.
            args.append(torch.tensor(lead_dim if lead_dim else batch, dtype=value.dtype, device=device))
            continue
        if lead_dim is None and shape:
            lead_dim = shape[0]
        args.append(torch.zeros(shape, dtype=value.dtype, device=device))
    with torch.no_grad():
        out = program.module()(*args).float().cpu()
    return {
        "input_shape": list(args[0].shape),
        "output_shape": list(out.shape),
        "finite": bool(torch.isfinite(out).all()),
        "min": float(out.min()),
        "max": float(out.max()),
    }
