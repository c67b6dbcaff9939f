"""Checkpoint files (counterpart of ``sensorium_tpu/engine/checkpoint.py``).

Two kinds, both msgpack written byte for byte as flax writes them
(``utils/msgpack.py``), so that either package reads the other's:

* a model checkpoint, ``{version, model_name, params, nn_state}``: the
  config dict (through a JSON round trip, which turns tuples into lists)
  and the eval (EMA) weights as ``{"params": ..., "batch_stats": ...}``
  nested in the JAX tree's names. Named ``model-{epoch:03d}-{score:.6f}.ckpt``
  so that ``utils.misc.get_best_model_path`` reads the score;
* a train state, ``{version, params, state, extra}``, for resuming a run;
* a sharded train state, a directory whose name ends in ``.orbax`` (the
  JAX package's name for its sharded format): ``meta.json`` holds JAX's
  keys (``version``, ``params``, ``extra``) and ``state/`` is written by
  ``torch.distributed.checkpoint``. Every process writes its own tensors,
  nothing is gathered, and a tensor that several processes hold under one
  key (a replicated one) is written once. The tensors of a model axis's
  slice k of n are keyed ``<name>@model<k>of<n>``, so the processes that
  hold one slice share a key and the slices stay apart. The load reads
  each process's keys straight into its live tensors; a state written
  over another model axis size is read whole, slice by slice, and
  resliced (``MouseModel.load_train_state``). The JAX package's
  own ``.orbax`` directories (orbax) are not read here, nor the port's
  there: the msgpack train state is the format both packages share.

Writes are atomic: a ``.tmp`` file, fsync, then ``os.replace``, so a killed
process never leaves a truncated checkpoint. A background save moves only
the serialization and the write off the caller's thread: the copy to the
host is made before the call returns, because the train step updates the
weights, the EMA and the moments in place.
"""

from __future__ import annotations

import json
import os
import re
import threading
from pathlib import Path
from typing import Any, Iterable

import numpy as np
import torch

from sensorium_tpu_torch.utils.msgpack import msgpack_pieces, msgpack_restore

MODEL_CHECKPOINT_VERSION = 1
DCP_METADATA = ".metadata"  # the file torch.distributed.checkpoint writes last into a checkpoint directory
SLICE_KEY = "{key}@model{index}of{count}"  # a sharded train state's key of a model axis's slice
SLICE_SUFFIX = re.compile(r"@model(\d+)of(\d+)$")


def to_host(tree):
    """A copy of a nested dict / list of tensors on the host, as numpy arrays
    (bf16 stays a CPU tensor: numpy has none). Always a copy, even of a CPU
    tensor, so later in-place updates cannot reach it."""
    if isinstance(tree, dict):
        return {key: to_host(value) for key, value in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_host(value) for value in tree]
    if isinstance(tree, torch.Tensor):
        host = tree.detach().to("cpu", copy=True)
        return host if host.dtype == torch.bfloat16 else host.numpy()
    return tree


class _AsyncWriter:
    """One background checkpoint write in flight at a time.

    Starting the next save, or any load, joins the previous write first, so
    writes land in order; a failed write's error is raised by the next wait.
    """

    def __init__(self):
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self._lock = threading.Lock()

    def _drain_locked(self) -> BaseException | None:
        thread, self._thread = self._thread, None
        if thread is not None:
            thread.join()
        error, self._error = self._error, None
        return error

    def wait(self) -> None:
        """Block until the write in flight (if any) ends; raise its error."""
        with self._lock:
            error = self._drain_locked()
        if error is not None:
            raise error

    def submit(self, path: Path, payload: dict) -> None:
        def run():
            try:
                _atomic_write(path, payload)
            except BaseException as exc:  # raised on the next wait()
                self._error = exc

        # Drain and replace under one hold of the lock: two submitters must
        # not both see no write in flight.
        with self._lock:
            error = self._drain_locked()
            if error is None:
                self._thread = threading.Thread(target=run, name=f"ckpt-write-{path.name}", daemon=True)
                self._thread.start()
        if error is not None:
            raise error


_writer = _AsyncWriter()


def flush_pending_saves() -> None:
    """Join the background write in flight, if any, and raise its error.
    Call before the process exits and before reading a file just saved."""
    _writer.wait()


def _atomic_write(path: Path, payload: dict) -> None:
    _atomic_write_pieces(path, msgpack_pieces(payload))


def _atomic_write_pieces(path: Path, pieces: Iterable[bytes]) -> None:
    tmp_path = path.with_name(path.name + ".tmp")
    with open(tmp_path, "wb") as handle:
        for piece in pieces:
            handle.write(piece)
        handle.flush()
        os.fsync(handle.fileno())
    os.replace(tmp_path, path)


def _save(path, payload: dict, background: bool) -> None:
    if background:
        _writer.submit(Path(path), payload)
    else:
        _writer.wait()
        _atomic_write(Path(path), payload)


def _read(path) -> Any:
    flush_pending_saves()
    with open(path, "rb") as handle:
        data = bytearray(os.fstat(handle.fileno()).st_size)
        handle.readinto(data)
    # A bytearray, so that the arrays read as views of it are writable.
    return msgpack_restore(data)


def save_model_checkpoint(path, argus_params: dict, nn_state: dict, model_name: str = "MouseModel",
                          background: bool = False) -> None:
    """Write an inference checkpoint: the config and ``nn_state``
    (``{"params": nested, "batch_stats": nested}``, tensors or arrays)."""
    payload = {
        "version": MODEL_CHECKPOINT_VERSION,
        "model_name": model_name,
        # The JSON round trip turns tuples into lists and refuses what is not plain data.
        "params": json.loads(json.dumps(argus_params)),
        "nn_state": to_host(nn_state),
    }
    _save(path, payload, background)


def load_model_checkpoint(path) -> dict[str, Any]:
    payload = _read(path)
    if payload.get("version") != MODEL_CHECKPOINT_VERSION:
        raise ValueError(f"Unsupported checkpoint version in {path}")
    return payload


def save_train_state(path, state: dict, argus_params: dict, extra: dict | None = None,
                     background: bool = False) -> None:
    """Write a resume checkpoint: ``state`` is a nested dict of tensors and
    arrays (``MouseModel.save_train_state`` builds it)."""
    payload = {
        "version": MODEL_CHECKPOINT_VERSION,
        "params": json.loads(json.dumps(argus_params)),
        "state": to_host(state),
        "extra": extra or {},
    }
    _save(path, payload, background)


def load_train_state(path) -> tuple[dict, dict]:
    """``(state, extra)`` of a resume checkpoint, arrays on the host."""
    payload = _read(path)
    if payload.get("version") != MODEL_CHECKPOINT_VERSION:
        raise ValueError(f"Unsupported checkpoint version in {path}")
    return payload["state"], payload.get("extra", {})


def save_train_state_sharded(dir_path, tensors: dict, argus_params: dict, extra: dict | None = None,
                             process_group=None, primary: bool = True) -> None:
    """Write a sharded resume checkpoint: ``tensors`` (flat names -> this
    process's tensors) into ``<dir>/state`` through
    ``torch.distributed.checkpoint``, then ``<dir>/meta.json`` from the
    ``primary`` process. Every process of ``process_group`` must call it
    (None: this process alone)."""
    import torch.distributed.checkpoint as dcp

    flush_pending_saves()
    dir_path = Path(dir_path)
    (dir_path / "state").mkdir(parents=True, exist_ok=True)
    dcp.save(tensors, checkpoint_id=dir_path / "state", process_group=process_group, no_dist=process_group is None)
    if primary:
        meta = {"version": MODEL_CHECKPOINT_VERSION, "params": json.loads(json.dumps(argus_params)),
                "extra": extra or {}}
        _atomic_write_pieces(dir_path / "meta.json", [json.dumps(meta).encode()])


def sharded_train_state_keys(dir_path) -> tuple[dict, dict]:
    """``(meta, {key: (shape, dtype)})`` of a sharded resume checkpoint.
    Raises ``ValueError`` for a directory that ``torch.distributed.checkpoint``
    did not write (for example one of the JAX package's, written by orbax)
    or a version this code does not read."""
    from torch.distributed.checkpoint import FileSystemReader
    from torch.distributed.checkpoint.metadata import TensorStorageMetadata

    dir_path = Path(dir_path)
    if not (dir_path / "state" / DCP_METADATA).is_file():
        raise ValueError(f"{dir_path} holds no torch.distributed.checkpoint metadata (state/{DCP_METADATA}): "
                         "it is not a sharded train state of this package (the JAX package's .orbax directories "
                         "are orbax's; the msgpack train state is the format both packages read)")
    meta = json.loads((dir_path / "meta.json").read_text())
    if meta.get("version") != MODEL_CHECKPOINT_VERSION:
        raise ValueError(f"Unsupported checkpoint version in {dir_path}")
    metadata = FileSystemReader(dir_path / "state").read_metadata()
    keys = {key: (tuple(item.size), item.properties.dtype) for key, item in metadata.state_dict_metadata.items()
            if isinstance(item, TensorStorageMetadata)}
    return meta, keys


def model_axis_of(keys) -> int:
    """The ``model`` axis size a sharded train state was written over (1: no slices)."""
    counts = {int(m.group(2)) for m in map(SLICE_SUFFIX.search, keys) if m}
    if len(counts) > 1:
        raise ValueError(f"a sharded train state with slices over model axes of sizes {sorted(counts)}")
    return counts.pop() if counts else 1


def load_train_state_sharded(dir_path, tensors: dict, process_group=None) -> None:
    """Read a sharded resume checkpoint into ``tensors`` (names -> tensors to
    fill in place, each with its key's shape); every process of
    ``process_group`` must call it (None: this process alone)."""
    import torch.distributed.checkpoint as dcp

    flush_pending_saves()
    dcp.load(tensors, checkpoint_id=Path(dir_path) / "state", process_group=process_group,
             no_dist=process_group is None)


def as_tensor(value) -> torch.Tensor:
    """A restored leaf (numpy array or scalar, or bf16 tensor) as a tensor
    of its own: a copy, not a view of the file's buffer."""
    if isinstance(value, torch.Tensor):
        return value.clone()
    return torch.from_numpy(np.array(value))
