"""ctypes binding to the native data loader (`helm_tpu_torch/native/loader.cpp`).

Counterpart of `helm_tpu/io/native_loader.py`: CSV test-vector parsing
and threaded batch LWE encryption in C++, for giant batched-serving vector
sets. The library is built with g++ on first use into `build/native/`
(`ops/build.py` `load_native`, cached by source hash). The reference falls
back to its Python CSV reader and a numpy encryptor when its library is
not built; the port has no fallback: a failed build or load raises with
the compiler's message. The C++ source is a copy of the reference's, so a
given (key, mu, noise, seed) gives the reference's ciphertexts word for
word, for every thread count.
"""

from __future__ import annotations

import ctypes
import hashlib

import numpy as np

from ..ops import build

_U32P = ctypes.POINTER(ctypes.c_uint32)


def load() -> ctypes.CDLL:
    """The loader library, built on first use (a failed build raises)."""
    lib = build.load_native("loader")
    if lib.helm_read_input_csv.restype is not ctypes.c_void_p:
        lib.helm_read_input_csv.restype = ctypes.c_void_p
        lib.helm_read_input_csv.argtypes = [ctypes.c_char_p, ctypes.c_int]
        lib.helm_loader_free.restype = None
        lib.helm_loader_free.argtypes = [ctypes.c_void_p]
        lib.helm_encrypt_lwe.restype = None
        lib.helm_encrypt_lwe.argtypes = [
            _U32P,  # key
            ctypes.c_int,  # n
            _U32P,  # mu
            ctypes.c_long,  # m
            ctypes.c_double,  # noise_std
            ctypes.c_char_p,  # key32 (256-bit ChaCha20 key)
            ctypes.c_int,  # nthreads
            _U32P,  # out
        ]
    return lib


def read_input_wires(file_name: str, ptxt_type: str) -> dict:
    """Same contract as io/csv_io.read_input_wires, parsed in C++; an
    unreadable or malformed CSV raises ValueError."""
    lib = load()
    is_bool = 1 if ptxt_type == "bool" else 0
    ptr = lib.helm_read_input_csv(str(file_name).encode(), is_bool)
    if not ptr:
        raise ValueError(f"unreadable or malformed input CSV: {file_name}")
    try:
        text = ctypes.string_at(ptr).decode()
    finally:
        lib.helm_loader_free(ptr)
    out: dict = {}
    for line in text.splitlines():
        name, _, val = line.partition("=")
        out[name] = bool(int(val)) if is_bool else int(val)
    return out


def _key32(seed) -> bytes:
    """Normalize a seed (int or bytes) to a 256-bit ChaCha20 key."""
    if isinstance(seed, (bytes, bytearray)) and len(seed) == 32:
        return bytes(seed)
    if isinstance(seed, int):
        seed = seed.to_bytes(32, "little", signed=False)
    return hashlib.sha256(b"helm_tpu-native-enc-v1:" + bytes(seed)).digest()


def encrypt_batch(
    key: np.ndarray,
    mu: np.ndarray,
    noise_std: float,
    seed,
    nthreads: int = 0,
) -> np.ndarray:
    """Batch LWE encryption of torus messages mu (uint32 [...]) under key
    (uint32 [n]): returns uint32 [..., n+1]. All cores by default. `seed`
    is 32 bytes of key material (or an int, hashed to 32 bytes); masks and
    noise come from ChaCha20 streams keyed by it, one stream per fixed
    1024-row block, so a given (seed, mu) yields the same ciphertexts for
    every nthreads value (and a batch is a prefix of a larger one)."""
    lib = load()
    key = np.ascontiguousarray(key, dtype=np.uint32)
    n = int(key.shape[0])
    mu = np.asarray(mu)
    mu_flat = np.ascontiguousarray(mu.reshape(-1), dtype=np.uint32)
    m = mu_flat.shape[0]
    out = np.empty((m, n + 1), dtype=np.uint32)
    lib.helm_encrypt_lwe(
        key.ctypes.data_as(_U32P), n, mu_flat.ctypes.data_as(_U32P), m,
        float(noise_std), _key32(seed), int(nthreads), out.ctypes.data_as(_U32P),
    )
    return out.reshape(*mu.shape, n + 1)
