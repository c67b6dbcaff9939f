"""ctypes bindings to the native host library (``native/sensorium_host.cpp``).

Counterpart of ``sensorium_tpu/data/native.py``: the hot host-side copies of
the data feed (time-window gathers, the fused StackInputs assembly, one call
per training sample) in C++, called on memory-mapped arrays. ctypes releases
the GIL for the call, so the loader's threads run them in parallel.

The source is the repository's ``native/sensorium_host.cpp``. It is compiled
on first use with ``g++`` (the Makefile's flags) into ``build/torch_host/``
at the root of the checkout, under a name that carries a hash of the source
and flags, and loaded once per process. A build that fails raises: there is
no silent fall-back. ``SENSORIUM_NATIVE=0`` selects the NumPy path instead,
explicitly, as in the JAX package. An entry point also returns the NumPy
path's answer (or None, for the caller to run it) for an array layout the
C++ code does not take.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_REPO = Path(__file__).resolve().parents[2]
SOURCE = _REPO / "native" / "sensorium_host.cpp"
BUILD_DIR = _REPO / "build" / "torch_host"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-Wall")

_lib = None
_lib_checked = False
# First use builds and loads under this lock: the loader's threads all reach
# here at once.
_load_lock = threading.Lock()


def reset() -> None:
    """Forget the loaded library, so that the next call reads
    ``SENSORIUM_NATIVE`` again. Datasets built before keep the per-trial
    fillers they made: build them anew after a reset."""
    global _lib, _lib_checked
    with _load_lock:
        _lib = None
        _lib_checked = False


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libsensorium_host-{digest[:16]}.so"


def build() -> Path:
    """Compile the library if there is no up-to-date one; raises if it cannot.

    A file lock keeps two processes from compiling at once, and the library
    is written to a temporary name and renamed, so no process ever loads a
    partial file.
    """
    path = library_path()
    if path.exists():
        return path
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found (and $CXX not set): the native host library cannot be built; "
                           "SENSORIUM_NATIVE=0 selects the NumPy path")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".build.lock", "w") as lock_file:
        fcntl.flock(lock_file, fcntl.LOCK_EX)
        if path.exists():
            return path
        tmp = path.with_suffix(f".{os.getpid()}.tmp")
        try:
            proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE), "-lpthread"],
                                  capture_output=True, text=True, timeout=300)
        except OSError as exc:
            raise RuntimeError(f"native host library build failed: cannot run {cxx}: {exc}") from exc
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"native host library build failed ({cxx} exit {proc.returncode}):\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, path)
    return path


def _load_library():
    """The configured library, or None under ``SENSORIUM_NATIVE=0``."""
    global _lib, _lib_checked
    if _lib_checked:
        return _lib
    with _load_lock:
        if not _lib_checked:
            if os.environ.get("SENSORIUM_NATIVE", "1") != "0":
                lib = ctypes.CDLL(str(build()))
                _configure(lib)
                _lib = lib
            _lib_checked = True
    return _lib


def _configure(lib) -> None:
    i64 = ctypes.c_int64
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int64)
    lib.gather_rows_f32.argtypes = [fp, i64, i64, ip, i64, fp]
    lib.gather_rows_f32.restype = None
    lib.gather_rows_relu_f32.argtypes = [fp, i64, i64, ip, i64, fp]
    lib.gather_rows_relu_f32.restype = None
    lib.fill_sample.argtypes = [
        fp, i64, i64, i64,  # video
        fp, i64,  # behavior
        fp, i64,  # pupil
        fp, i64, i64,  # responses (nullable)
        ip, i64,  # indexes
        i64, i64, ctypes.c_float,  # out_h, out_w, fill
        fp, fp,  # input_out, target_out (nullable)
    ]
    lib.fill_sample.restype = None
    lib.assemble_stack_input.argtypes = [
        fp, i64, i64, i64,  # video
        fp, i64,  # behavior
        fp, i64,  # pupil
        ip, i64,  # indexes
        i64, i64, ctypes.c_float,  # out_h, out_w, fill
        fp,
    ]
    lib.assemble_stack_input.restype = None


def available() -> bool:
    return _load_library() is not None


def _f32ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _i64ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


def gather_rows(src: np.ndarray, indexes: np.ndarray) -> np.ndarray:
    """``src[..., indexes]`` for 2-D float32 row-major ``src`` (rows, T)."""
    lib = _load_library()
    indexes = np.ascontiguousarray(indexes, dtype=np.int64)
    if lib is None or src.dtype != np.float32 or src.ndim != 2 or src.strides != (src.shape[1] * 4, 4):
        return np.ascontiguousarray(src[..., indexes])
    rows, t = src.shape
    if indexes.size == 0 or indexes.min() < 0 or indexes.max() >= t:
        return np.ascontiguousarray(src[..., indexes])  # NumPy raises the IndexError
    out = np.empty((rows, indexes.shape[0]), np.float32)
    lib.gather_rows_f32(_f32ptr(src), rows, t, _i64ptr(indexes), indexes.shape[0], _f32ptr(out))
    return out


def gather_rows_relu_into(src: np.ndarray, indexes: np.ndarray, out: np.ndarray) -> bool:
    """``out[...] = max(src[..., indexes], 0)`` for 2-D float32 ``src``,
    written into ``out`` (a batch row); False when the library or the layout
    cannot (the caller then runs NumPy)."""
    lib = _load_library()
    if (
        lib is None
        or src.dtype != np.float32
        or out.dtype != np.float32
        or src.ndim != 2
        or src.strides != (src.shape[1] * 4, 4)
        or not out.flags["C_CONTIGUOUS"]
        or out.shape != (src.shape[0], indexes.shape[0])
    ):
        return False
    rows, t = src.shape
    indexes = np.ascontiguousarray(indexes, dtype=np.int64)
    if indexes.size == 0 or indexes.min() < 0 or indexes.max() >= t:
        return False  # the caller's NumPy path raises the IndexError
    lib.gather_rows_relu_f32(_f32ptr(src), rows, t, _i64ptr(indexes), indexes.shape[0], _f32ptr(out))
    return True


def make_trial_filler(
    video: np.ndarray,
    behavior: np.ndarray,
    pupil_center: np.ndarray,
    responses: np.ndarray | None,
    out_size: tuple[int, int],
):
    """A per-trial sample filler, or None if the library or the layout cannot.

    Layout checks and pointer conversions run once per trial here; the
    returned ``fill(indexes, fill_value, input_out, target_out)`` makes one
    native call per sample. It keeps the source arrays alive.
    """
    lib = _load_library()
    if lib is None or video.dtype != np.float32 or video.ndim != 3:
        return None
    h, w, t = video.shape
    if video.strides != (w * t * 4, t * 4, 4):
        return None
    width, height = out_size
    if h > height or w > width:
        return None
    for sig in (behavior, pupil_center):
        # The C++ code reads exactly 2 rows.
        if sig.dtype != np.float32 or sig.ndim != 2 or sig.shape[0] != 2 or not sig.flags["C_CONTIGUOUS"]:
            return None
    if responses is not None:
        if (
            responses.dtype != np.float32
            or responses.ndim != 2
            or responses.strides != (responses.shape[1] * 4, 4)
        ):
            return None
        resp_ptr = _f32ptr(responses)
        resp_rows, resp_t = responses.shape
    else:
        resp_ptr, resp_rows, resp_t = None, 0, 0

    video_ptr, behavior_ptr, pupil_ptr = _f32ptr(video), _f32ptr(behavior), _f32ptr(pupil_center)
    bt, pt = behavior.shape[-1], pupil_center.shape[-1]
    # Window indexes address every source's time axis, and the trial length
    # comes from one file: bound them by the shortest.
    time_limit = min(t, bt, pt) if responses is None else min(t, bt, pt, resp_t)
    fill_sample = lib.fill_sample
    sources = (video, behavior, pupil_center, responses)

    def fill(indexes: np.ndarray, fill_value: float, input_out, target_out) -> None:
        assert sources is not None  # the closure holds the source arrays
        indexes = np.ascontiguousarray(indexes, dtype=np.int64)
        s = indexes.shape[0]
        # NumPy would raise on these; the C++ code would read out of bounds.
        if s == 0 or indexes.min() < 0 or indexes.max() >= time_limit:
            raise IndexError(
                f"window indexes out of range [0, {time_limit}) for trial sources (video t={t}, "
                f"behavior t={bt}, pupil t={pt}, responses t={resp_t if responses is not None else 'n/a'})"
            )
        if input_out.dtype != np.float32 or not input_out.flags["C_CONTIGUOUS"] or input_out.shape != (
            5, s, height, width
        ):
            raise ValueError(f"input_out must be C-contiguous float32 (5, {s}, {height}, {width}); "
                             f"got {input_out.dtype} {input_out.shape}")
        if target_out is not None and (
            responses is None
            or target_out.dtype != np.float32
            or not target_out.flags["C_CONTIGUOUS"]
            or target_out.shape != (resp_rows, s)
        ):
            raise ValueError(f"target_out must be C-contiguous float32 ({resp_rows}, {s}) matching the "
                             f"responses file; got {target_out.dtype} {target_out.shape}")
        fill_sample(
            video_ptr, h, w, t,
            behavior_ptr, bt,
            pupil_ptr, pt,
            resp_ptr, resp_rows, resp_t,
            _i64ptr(indexes), s,
            height, width, ctypes.c_float(fill_value),
            _f32ptr(input_out),
            _f32ptr(target_out) if target_out is not None else None,
        )

    return fill


def assemble_stack_input(
    video: np.ndarray,  # (H, W, T) float32, C-contiguous (mmap ok)
    behavior: np.ndarray,  # (2, T)
    pupil_center: np.ndarray,  # (2, T)
    indexes: np.ndarray,  # (S,) window frame indexes
    out_size: tuple[int, int],  # (width, height) canvas
    fill: float = 0.0,
    out: np.ndarray | None = None,
) -> np.ndarray | None:
    """Window gather, canvas padding and broadcast into (5, S, H', W') in
    one pass; None when the library or the layout cannot (the caller then
    runs the NumPy processor)."""
    lib = _load_library()
    if lib is None or video.dtype != np.float32 or video.ndim != 3:
        return None
    if behavior.dtype != np.float32 or pupil_center.dtype != np.float32:
        return None
    h, w, t = video.shape
    if video.strides != (w * t * 4, t * 4, 4):
        return None
    for sig in (behavior, pupil_center):
        if sig.ndim != 2 or sig.shape[0] != 2:
            return None
    width, height = out_size
    if h > height or w > width:
        return None
    indexes = np.ascontiguousarray(indexes, dtype=np.int64)
    s = indexes.shape[0]
    time_limit = min(t, behavior.shape[-1], pupil_center.shape[-1])
    if s == 0 or indexes.min() < 0 or indexes.max() >= time_limit:
        return None  # the NumPy processor raises the IndexError
    if out is not None and (
        out.dtype != np.float32 or not out.flags["C_CONTIGUOUS"] or out.shape != (5, s, height, width)
    ):
        return None
    if out is None:
        out = np.empty((5, s, height, width), np.float32)
    behavior_c = np.ascontiguousarray(behavior)
    pupil_c = np.ascontiguousarray(pupil_center)
    lib.assemble_stack_input(
        _f32ptr(video), h, w, t,
        _f32ptr(behavior_c), behavior_c.shape[-1],
        _f32ptr(pupil_c), pupil_c.shape[-1],
        _i64ptr(indexes), s,
        height, width, ctypes.c_float(fill),
        _f32ptr(out),
    )
    return out
