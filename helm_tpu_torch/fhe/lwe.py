"""Client-side key generation, encryption, decryption (host, numpy).

The client role of the reference: key generation at startup and
encrypt-inputs / decrypt-outputs around evaluation (reference:
src/bin/helm.rs:241,248,281; src/circuit.rs:450-480,551-576). Keys and
ciphertexts are plain numpy uint32 arrays; q = 2^32.

The port's own copy of `helm_tpu/fhe/lwe.py`, trimmed to what the port
calls, so that helm_tpu_torch imports nothing of the JAX package; the
tests/test_torch_*.py files hold it against the original.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from ..params import Q, TfheParams, from_reference
from .csprng import make_rng


@dataclass
class ClientKey:
    params: TfheParams
    lwe_key: np.ndarray  # uint32 [n], binary
    glwe_key: np.ndarray  # uint32 [k, N], binary
    # ChaCha20 CSPRNG by default (csprng.make_rng); numpy PCG64 only under
    # HELM_TPU_INSECURE_PRNG=1 (bench mode) — see SECURITY.md "Randomness"
    rng: object = field(repr=False)

    @property
    def extracted_key(self) -> np.ndarray:
        """Big-LWE key after sample extract: glwe key flattened [k*N]."""
        return self.glwe_key.reshape(-1)


def keygen(params: TfheParams, seed: int | None = None) -> ClientKey:
    rng = make_rng(seed)
    lwe_key = rng.integers(0, 2, size=params.n, dtype=np.uint32)
    glwe_key = rng.integers(0, 2, size=(params.k, params.N), dtype=np.uint32)
    return ClientKey(params, lwe_key, glwe_key, rng)


def _noise(rng, std: float, shape) -> np.ndarray:
    if std <= 0.0:
        return np.zeros(shape, dtype=np.uint32)
    e = np.rint(rng.normal(0.0, std, size=shape)).astype(np.int64)
    return (e % Q).astype(np.uint32)


def encrypt(
    ck: ClientKey, mu: np.ndarray, big: bool = False, std: float | None = None
) -> np.ndarray:
    """LWE-encrypt torus values mu (uint32 [...]): returns uint32 [..., n+1]."""
    key = ck.extracted_key if big else ck.lwe_key
    n = key.shape[0]
    if std is None:
        std = ck.params.glwe_noise_std if big else ck.params.lwe_noise_std
    mu = np.asarray(mu, dtype=np.uint32)
    a = ck.rng.integers(0, Q, size=mu.shape + (n,), dtype=np.uint32)
    dot = (a.astype(np.uint64) * key.astype(np.uint64)).sum(axis=-1)
    with np.errstate(over="ignore"):  # wrapping mod q is the point
        b = (dot.astype(np.uint32) + mu + _noise(ck.rng, std, mu.shape)).astype(
            np.uint32
        )
    return np.concatenate([a, b[..., None]], axis=-1)


def encrypt_many(
    ck: ClientKey, mu: np.ndarray, native_threshold: int = 1 << 13
) -> np.ndarray:
    """encrypt(), but batches of `native_threshold` messages or more go to
    the threaded C++ encryptor (`io/native_loader.py`, built on first use)
    with 256 bits of fresh key material from the key's stream — the
    client-side hot path of batched serving. Below the threshold this is
    exactly encrypt(), its rng stream included."""
    mu = np.asarray(mu, dtype=np.uint32)
    if mu.size >= native_threshold:
        from ..io import native_loader

        return native_loader.encrypt_batch(
            ck.lwe_key, mu, ck.params.lwe_noise_std, seed=ck.rng.bytes(32)
        )
    return encrypt(ck, mu)


def client_key_from_reference(ck) -> ClientKey:
    """The port's ClientKey for a `helm_tpu.fhe.lwe.ClientKey` (duck-typed:
    nothing of helm_tpu is imported). The key arrays are copied; the
    random stream is a fresh one (make_rng()), as a loaded key file gets,
    so that the two keys never draw the same masks."""
    return ClientKey(
        from_reference(ck.params),
        np.array(ck.lwe_key, dtype=np.uint32),
        np.array(ck.glwe_key, dtype=np.uint32),
        make_rng(),
    )


def decrypt_phase(ck: ClientKey, ct: np.ndarray, big: bool = False) -> np.ndarray:
    """Raw phase b - <a, s> (uint32 [...])."""
    key = ck.extracted_key if big else ck.lwe_key
    n = key.shape[0]
    ct = np.asarray(ct)
    a, b = ct[..., :n], ct[..., n]
    dot = (a.astype(np.uint64) * key.astype(np.uint64)).sum(axis=-1)
    return (b - dot.astype(np.uint32)).astype(np.uint32)


# ----------------------------------------------------------------------
# Encodings
# ----------------------------------------------------------------------

BOOL_TRUE = np.uint32(Q // 8)  # +1/8 torus — reference circuit.rs:29
BOOL_FALSE = np.uint32(Q - Q // 8)  # -1/8 torus — reference circuit.rs:33


def encode_bool(bits) -> np.ndarray:
    bits = np.asarray(bits, dtype=bool)
    return np.where(bits, BOOL_TRUE, BOOL_FALSE).astype(np.uint32)


def decode_bool(phase: np.ndarray) -> np.ndarray:
    """phase in (0, q/2) => True — reference circuit.rs:948."""
    return np.asarray(phase) < np.uint32(1 << 31)


def encode_msg(params: TfheParams, m) -> np.ndarray:
    """Shortint-style encoding m * delta (with padding bit in msg_space)."""
    return (np.asarray(m, dtype=np.uint64) * params.delta % Q).astype(np.uint32)


def decode_msg(params: TfheParams, phase: np.ndarray) -> np.ndarray:
    """Nearest-slot decode -> message in [0, msg_space)."""
    p = np.asarray(phase, dtype=np.uint64)
    half = params.delta // 2
    return (((p + half) // params.delta) % params.msg_space).astype(np.uint64)
