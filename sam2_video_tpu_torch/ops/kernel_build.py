"""Builds the hand-written CUDA kernels and loads them with ctypes.

Each ``csrc/<name>.cu`` compiles with nvcc for ``sm_90a`` into
``build/lib<name>.so`` with a plain C interface. The build runs on first
use, from the sources in this package only, one nvcc process per source,
all started together. A library is rebuilt when a source is newer than it.
There is no fallback: without nvcc the build raises.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "build"
SOURCES = ("hiera_block", "hiera_block_bwd", "memory_encoder", "flash_kproj",
           "flash_attention", "memattn_layer", "twoway_block")
DEFAULT_CUDA_HOME = "/usr/local/cuda"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def find_nvcc() -> str:
    """Path of nvcc: on PATH, under $CUDA_HOME / $CUDA_PATH, or under
    DEFAULT_CUDA_HOME."""
    cands = [shutil.which("nvcc")]
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(os.path.join(os.environ[env], "bin", "nvcc"))
    cands.append(os.path.join(DEFAULT_CUDA_HOME, "bin", "nvcc"))
    for c in cands:
        if c and os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        f"nvcc not found (PATH, $CUDA_HOME/bin, {DEFAULT_CUDA_HOME}/bin): the "
        "CUDA kernels of sam2_video_tpu_torch are compiled with nvcc for "
        "sm_90a on first use, and there is no fallback for a CUDA tensor")


def _lib_path(name: str) -> Path:
    return BUILD / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not lib.exists():
        return True
    deps = [CSRC / f"{name}.cu", *CSRC.glob("*.cuh")]
    return max(d.stat().st_mtime for d in deps) > lib.stat().st_mtime


def build(force: bool = False) -> dict[str, str]:
    """Compile the sources that are stale (all with ``force``) in parallel,
    one nvcc each. Returns nvcc's output (with ptxas's register and spill
    report) per source; raises with that output on a failure."""
    todo = [n for n in SOURCES if force or _stale(n)]
    if not todo:
        return {}
    nvcc = find_nvcc()
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n in todo:
        tmp = BUILD / f"lib{n}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{n}.cu")]
        procs[n] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT,
                                          text=True))
    failed, logs = [], {}
    for n, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs[n] = out
        if proc.returncode != 0:
            failed.append(f"--- {n}.cu (nvcc exit {proc.returncode}) ---\n"
                          + out)
        else:
            os.replace(tmp, _lib_path(n))
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``lib<name>.so``, built first when needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build()
            lib = ctypes.CDLL(str(_lib_path(name)))
            _libs[name] = lib
        return lib


def check_launch(status: int, what: str) -> None:
    """Raise if the C entry point reported a CUDA error for its launches."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch "
                           "(cudaGetLastError)")
