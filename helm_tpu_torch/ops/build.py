"""Build the CUDA sources in `csrc/` with nvcc, and the host C++ sources in
`native/` with g++, and load them with ctypes.

Each `csrc/<name>.cu` has a plain C interface (no PyTorch headers) and is
compiled on first use into `build/kernels/lib<name>-<hash>.so` at the
repository root, for `sm_90a` (Hopper). The hash covers the source, the
shared headers (`csrc/*.cuh`) and the flags, so an edited source rebuilds
and an unchanged one loads the cached library. `load_all` starts one nvcc
per source at once and waits for them all. `load_native(name)` builds
`native/<name>.cpp` (the client-side loader and netlist parser) the same
way into `build/native/`. Unlike `helm_tpu/circuit/native.py` there is no
fallback: a missing compiler or a failed build raises with its message.

Every C entry point of a kernel returns `cudaGetLastError()`; `check`
raises when it is not 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
NATIVE = Path(__file__).resolve().parents[1] / "native"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NATIVE_BUILD_DIR = BUILD_DIR.parent / "native"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]
GXX_FLAGS = ["-O2", "-std=c++17", "-fPIC", "-shared"]
#: the libraries each native/<name>.cpp links
NATIVE_LIBS = {"loader": ["-lpthread"], "graph": []}

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


def _hashed(name: str, sources, flags, out_dir: Path) -> Path:
    """out_dir/lib<name>-<hash>.so, the hash over the sources and flags."""
    h = hashlib.sha256()
    for src in sources:
        h.update(src.read_bytes())
    h.update(" ".join(flags).encode())
    return out_dir / f"lib{name}-{h.hexdigest()[:16]}.so"


def _library(name: str) -> Path:
    return _hashed(name, [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))], NVCC_FLAGS, BUILD_DIR)


def _compile(jobs) -> None:
    """Run every (source, command writing tmp, tmp, so) compile at once and
    move each output to its cached name; raise with every failing
    compiler's output."""
    procs = []
    for src, cmd, tmp, so in jobs:
        so.parent.mkdir(parents=True, exist_ok=True)
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        procs.append((src, cmd, proc, tmp, so))
    failed = []
    for src, cmd, proc, tmp, so in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{cmd[0]} failed for {src.name} (rc {proc.returncode}):\n{' '.join(cmd)}\n{out}")
        else:
            os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))


def load_all(names) -> dict[str, ctypes.CDLL]:
    """Compile every csrc/<name>.cu not yet built (one nvcc each, all
    started together; cached by source hash) and dlopen them."""
    jobs = []
    for name in names:
        so = _library(name)
        if name in _LIBS or so.exists():
            continue
        tmp = so.with_suffix(f".{os.getpid()}.tmp")
        src = CSRC / f"{name}.cu"
        jobs.append((src, [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)], tmp, so))
    _compile(jobs)
    for name in names:
        if name not in _LIBS:
            _LIBS[name] = ctypes.CDLL(str(_library(name)))
    return {name: _LIBS[name] for name in names}


def load_native(name: str) -> ctypes.CDLL:
    """Compile native/<name>.cpp with g++ on first use into
    build/native/lib<name>-<hash>.so (cached by source hash) and dlopen it;
    a missing g++ or a failed build raises with the compiler's message."""
    key = f"native/{name}"
    if key not in _LIBS:
        src = NATIVE / f"{name}.cpp"
        flags = GXX_FLAGS + NATIVE_LIBS[name]
        so = _hashed(name, [src], flags, NATIVE_BUILD_DIR)
        if not so.exists():
            gxx = shutil.which("g++")
            if gxx is None:
                raise RuntimeError(f"g++ not found: helm_tpu_torch/native/{name}.cpp is built on first use")
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            _compile([(src, [gxx, *GXX_FLAGS, "-o", str(tmp), str(src), *NATIVE_LIBS[name]], tmp, so)])
        _LIBS[key] = ctypes.CDLL(str(so))
    return _LIBS[key]


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
