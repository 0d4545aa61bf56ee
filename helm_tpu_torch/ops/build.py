"""Build the CUDA sources in `csrc/` with nvcc and load them with ctypes.

Each `csrc/<name>.cu` has a plain C interface (no PyTorch headers) and is
compiled on first use into `build/kernels/lib<name>-<hash>.so` at the
repository root, for `sm_90a` (Hopper). The hash covers the source, the
shared headers (`csrc/*.cuh`) and the flags, so an edited source rebuilds
and an unchanged one loads the cached library. `load_all` starts one nvcc
per source at once and waits for them all. Unlike `helm_tpu/circuit/native.py` there is no fallback:
a missing `nvcc` or a failed build raises.

Every C entry point returns `cudaGetLastError()`; `check` raises when it
is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "helm_tpu_torch are built from csrc/ on first use"
    )


def _library(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for dep in sorted(CSRC.glob("*.cuh")):
        h.update(dep.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def load_all(names) -> dict[str, ctypes.CDLL]:
    """Compile every csrc/<name>.cu not yet built (one nvcc each, all
    started together; cached by source hash) and dlopen them."""
    jobs = []
    for name in names:
        so = _library(name)
        if name in _LIBS or so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((name, cmd, proc, tmp, so))
    failed = []
    for name, cmd, proc, tmp, so in jobs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{' '.join(cmd)}\n{out}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))
    for name in names:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(str(_library(name)))
    return {name: _LIBS[name] for name in names}


def load(name: str) -> ctypes.CDLL:
    """Compile csrc/<name>.cu (cached by source hash) and dlopen it."""
    return load_all([name])[name]


def entry(name: str, argtypes: list, symbol: str | None = None):
    """The C entry point `symbol` (default helm_<name>) of csrc/<name>.cu
    (built and loaded on first use), with its argument types declared and
    an int return."""
    fn = getattr(load(name), symbol or f"helm_{name}")
    if fn.argtypes is None:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def check(rc: int, what: str) -> None:
    """Raise on a non-zero cudaError_t from a C entry point."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")
