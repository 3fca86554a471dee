"""Build and load the CUDA kernels in `csrc/`.

Each `csrc/<name>.cu` compiles with `nvcc` for `sm_90a` into its own
shared library with a plain C interface, `build/<name>-<hash>.so`, where
the hash covers every source and header in `csrc/` and the flags. The
first call builds whatever is missing, one `nvcc` per source, all started
together; later calls load the cached libraries with ctypes. Nothing is
built or loaded when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

_HERE = Path(__file__).resolve().parent
SRC_DIR = _HERE / "csrc"
BUILD_DIR = _HERE / "build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int64
# C signature of each entry point `fm_<name>`: device pointers, then
# sizes, then the CUDA stream (appended below).
_ARGTYPES = {
    "masked_stats": [_P] * 5 + [_I] * 2,
    "ma_judgment": [_P] * 12 + [_I] * 3,
    "ma_judgment_bf16_delta": [_P] * 13 + [_I] * 3,
    "holt_winters_scan": [_P] * 11 + [_I] * 5,
    "holt_scan": [_P] * 8 + [_I] * 2,
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME")
    if home and (Path(home) / "bin" / "nvcc").exists():
        return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(SRC_DIR.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _lib_path(name: str, digest: str) -> Path:
    return BUILD_DIR / f"{name}-{digest}.so"


def build_all() -> float:
    """Compile every kernel library that is not built yet, in parallel.
    Returns the seconds spent; raises with nvcc's output on failure."""
    t0 = time.perf_counter()
    digest = _source_hash()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = []
    for name in _ARGTYPES:
        out = _lib_path(name, digest)
        if out.exists():
            continue
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        log = open(out.with_suffix(".log"), "w")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT)
        jobs.append((name, proc, tmp, out, log))
    failed = []
    for name, proc, tmp, out, log in jobs:
        rc = proc.wait()
        log.close()
        if rc == 0:
            os.replace(tmp, out)  # atomic: a reader never sees half a file
        else:
            failed.append(f"{name} (rc={rc}):\n{out.with_suffix('.log').read_text()}")
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return time.perf_counter() - t0


def build_log(name: str) -> str:
    """nvcc's output (ptxas register and shared-memory report) of the
    current build of `name`."""
    return _lib_path(name, _source_hash()).with_suffix(".log").read_text()


def library(name: str) -> ctypes.CDLL:
    """The loaded library of kernel `name`, building all kernels first if
    needed, with argtypes set on `fm_<name>`."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _lock:
        if name not in _libs:
            build_all()
            digest = _source_hash()
            for kname, argtypes in _ARGTYPES.items():
                loaded = ctypes.CDLL(str(_lib_path(kname, digest)))
                fn = getattr(loaded, f"fm_{kname}")
                fn.argtypes = [*argtypes, _P]
                fn.restype = ctypes.c_int
                loaded.fm_error_string.argtypes = [ctypes.c_int]
                loaded.fm_error_string.restype = ctypes.c_char_p
                _libs[kname] = loaded
    return _libs[name]
