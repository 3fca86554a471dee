"""ctypes bindings for the host packing library (`ops/csrc/windowpack.cpp`).

The port's own copy of the JAX package's `native.py`, over its own copy
of `native/windowpack.cpp`. The library is built with `g++` into the
git-ignored `ops/build/` on first use (about a second), keyed by a hash
of the source and flags, and loaded with ctypes; nothing is built or
loaded when this module is imported. The worker CLI calls
`ensure_built()` at startup so the build never lands inside a tick, and
logs a failed build loudly. Without the library every caller falls back
to the numpy row loops below (`pack_windows_plain`,
`pack_bf16_delta_plain`), which are also what the tests hold the library
to. `FOREMAST_NATIVE=0` turns the library off.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

log = logging.getLogger("foremast_tpu_torch.native")

_OPS = Path(__file__).resolve().parent / "ops"
SOURCE = _OPS / "csrc" / "windowpack.cpp"
BUILD_DIR = _OPS / "build"
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread")
ABI_VERSION = 6

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
_tried = False
_error: str | None = None


def _lib_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libforemast_native-{h.hexdigest()[:16]}.so"


def _build(out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cxx = os.environ.get("CXX") or "g++"
    proc = subprocess.run(
        [cxx, *CXX_FLAGS, str(SOURCE), "-o", str(tmp)],
        capture_output=True, text=True, timeout=120,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"{cxx} failed (rc={proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)  # atomic: a reader never maps half a file


def load() -> ctypes.CDLL | None:
    """The library, built on the first call if missing; None when it is
    turned off (`FOREMAST_NATIVE=0`) or cannot be built or loaded (the
    reason is in `error()` and was logged once)."""
    global _lib, _tried, _error
    if os.environ.get("FOREMAST_NATIVE", "") == "0":
        return None
    # every read of the loader state is under the lock: `_tried` is set
    # before the build and `_lib` after it, so a caller that read
    # `_tried` outside would take the numpy loops while another thread
    # builds
    with _lock:
        if _tried:
            return _lib
        _tried = True
        try:
            path = _lib_path()
            if not path.exists():
                # one-shot startup path: the lock spans the build, so a
                # racing load() waits for the library instead of packing
                # without it
                _build(path)  # foremast: ignore[blocking-under-lock] — one-shot build, see above
            lib = ctypes.CDLL(str(path))
            lib.fp_abi_version.restype = ctypes.c_int32
            if lib.fp_abi_version() != ABI_VERSION:
                raise RuntimeError(f"abi {lib.fp_abi_version()} != {ABI_VERSION}")
        except Exception as e:  # noqa: BLE001 - any failure means the plain loops
            _error = f"{type(e).__name__}: {e}"
            log.error("native packing library unavailable, numpy fallback active: %s", _error)
            return None
        ptr = ctypes.POINTER(ctypes.c_void_p)
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
        lib.fp_pack_windows.argtypes = [
            ptr, ptr, i64p, ctypes.c_int64, ctypes.c_int64,
            f32p, ctypes.c_void_p, u8p,
        ]
        lib.fp_pack_windows.restype = None
        lib.fp_pack_bf16_delta.argtypes = [
            ptr, i64p, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_void_p, f32p, i32p,
        ]
        lib.fp_pack_bf16_delta.restype = None
        _lib = lib
        return _lib


def ensure_built() -> bool:
    """Build and load the library now (the worker's startup hook), so the
    first cold tick never pays the build. False (already logged) when it
    is unavailable."""
    return load() is not None


def error() -> str | None:
    """Why the library is unavailable, or None."""
    # a status read for the startup warning: one reference, set once
    # under _lock; taking the lock here would wait out a build
    return _error  # foremast: ignore[lock-discipline] — racy status read, see above


def _value_rows(series) -> list[np.ndarray]:
    return [np.ascontiguousarray(v, dtype=np.float32) for _, v in series]


def _pointers(arrays) -> ctypes.Array:
    return (ctypes.c_void_p * len(arrays))(*(a.ctypes.data for a in arrays))


def pack_windows(
    series, length: int, with_times: bool = True
) -> tuple[np.ndarray, np.ndarray | None, np.ndarray] | None:
    """Ragged (times, values) series -> (values f32 [B, T], times i32
    [B, T] or None, mask bool [B, T]): rows truncated to `length`, the
    padding zero, times cast to int32. None when the library is
    unavailable. `with_times=False` skips the times."""
    lib = load()
    if lib is None:
        return None
    b = len(series)
    vals = _value_rows(series)
    times = [np.ascontiguousarray(t, dtype=np.int64) for t, _ in series] if with_times else []
    for i, (t, v) in enumerate(zip(times, vals)):
        if len(t) != len(v):  # the C code indexes times by len(values)
            raise ValueError(f"series {i}: {len(t)} timestamps for {len(v)} values")
    lens = np.fromiter((len(v) for v in vals), np.int64, count=b)
    # np.zeros: only each row's valid prefix is written, so the padding
    # stays on copy-on-write zero pages
    out_values = np.zeros((b, length), np.float32)
    out_times = np.zeros((b, length), np.int32) if with_times else None
    out_mask = np.zeros((b, length), np.uint8)
    if b:
        lib.fp_pack_windows(
            _pointers(vals), _pointers(times) if with_times else None, lens, b, length,
            out_values, None if out_times is None else out_times.ctypes.data, out_mask,
        )
    return out_values, out_times, out_mask.view(bool)


def pack_windows_plain(
    series, length: int, with_times: bool = True
) -> tuple[np.ndarray, np.ndarray | None, np.ndarray]:
    """`pack_windows` as a numpy row loop (the fallback, and what the
    tests hold the library to)."""
    b = len(series)
    values = np.zeros((b, length), np.float32)
    times = np.zeros((b, length), np.int32) if with_times else None
    mask = np.zeros((b, length), bool)
    for i, (t, v) in enumerate(series):
        n = min(len(v), length)
        values[i, :n] = np.asarray(v, np.float32)[:n]
        if with_times:
            times[i, :n] = np.asarray(t, np.int64)[:n].astype(np.int32)
        mask[i, :n] = True
    return values, times, mask


def pack_bf16_delta(series, length: int, out: np.ndarray | None = None):
    """Anchor-shifted bf16-delta packing: (anchor f32 [B], delta [B, L]
    as uint16 bf16 bits, lens int32 [B]). Anchor is each row's first
    valid value (0 for an empty row), deltas are `v - anchor` in f32
    rounded to bf16 (nearest even; NaN the quiet NaN of its sign), the
    padding +0.0. `out` (uint16 [B, L], C-contiguous, e.g. a pinned
    buffer) receives the deltas and need not be zeroed. None when the
    library is unavailable."""
    lib = load()
    if lib is None:
        return None
    b = len(series)
    vals = _value_rows(series)
    lens_in = np.fromiter((len(v) for v in vals), np.int64, count=b)
    if out is None:
        out = np.empty((b, length), np.uint16)
    if out.shape != (b, length) or out.dtype != np.uint16 or not out.flags.c_contiguous:
        raise ValueError(f"out must be C-contiguous uint16 {(b, length)}, got {out.dtype} {out.shape}")
    anchor = np.zeros(b, np.float32)
    lens = np.zeros(b, np.int32)
    if b:
        lib.fp_pack_bf16_delta(_pointers(vals), lens_in, b, length, out.ctypes.data, anchor, lens)
    return anchor, out, lens


def bf16_bits(x: np.ndarray) -> np.ndarray:
    """float32 -> bfloat16 bits (uint16) by the library's rule, in numpy."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    r = ((u + np.uint32(0x7FFF) + ((u >> 16) & np.uint32(1))) >> 16).astype(np.uint16)
    nan = (u & np.uint32(0x7FFFFFFF)) > np.uint32(0x7F800000)
    return np.where(nan, ((u >> 16) & np.uint32(0x8000)).astype(np.uint16) | np.uint16(0x7FC0), r)


def pack_bf16_delta_plain(series, length: int):
    """`pack_bf16_delta` as a numpy row loop (the fallback, and what the
    tests hold the library to)."""
    b = len(series)
    delta = np.zeros((b, length), np.float32)
    anchor = np.zeros(b, np.float32)
    lens = np.zeros(b, np.int32)
    for i, (_, v) in enumerate(series):
        n = min(len(v), length)
        if n:
            row = np.asarray(v, np.float32)[:n]
            anchor[i] = row[0]
            np.subtract(row, anchor[i], out=delta[i, :n])
        lens[i] = n
    return anchor, bf16_bits(delta), lens
