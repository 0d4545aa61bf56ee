"""Cryptographically secure client-side randomness (ChaCha20, numpy).

The reference's client role is tfhe-rs, which draws every mask and noise
sample from a seeded CSPRNG (reference L0: Cargo.toml:18 — tfhe-rs uses
concrete-csprng's AES/ChaCha-based generators throughout). Round 1 of this
repo used numpy PCG64 (and xoshiro256** in the C++ encryptor) — fast but
predictable from output, which is disqualifying for the *client* side of an
FHE deployment: LWE masks and noise are exactly the secrets that make
ciphertexts semantically secure.

This module implements the ChaCha20 block function (RFC 8439) vectorized
over blocks in numpy and exposes `ChaChaGenerator`, a drop-in for the small
slice of the `numpy.random.Generator` API the client layer uses
(`integers`, `normal`, `bytes`). `make_rng()` is the factory every key/
encrypt path goes through:

- default: ChaCha20, keyed by SHA-256(domain || seed) for reproducible
  seeded streams, or by os.urandom(32) when unseeded;
- HELM_TPU_INSECURE_PRNG=1 opts back into numpy PCG64 (bench mode — keygen
  is ~2x faster; never use for real key material).

Known-answer test: tests/test_params_keys.py pins the RFC 8439 §2.3.2
block-function vector plus uniformity/normality distribution checks.

The port's own copy of `helm_tpu/fhe/csprng.py`, trimmed to what the
port calls, so that helm_tpu_torch imports nothing of the JAX package;
the tests/test_torch_*.py files hold it against the original.
"""

from __future__ import annotations

import hashlib
import os

import numpy as np

_CONST = np.array(
    [0x61707865, 0x3320646E, 0x79622D32, 0x6B206574], dtype=np.uint32
)


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def _qr(x: np.ndarray, a: int, b: int, c: int, d: int) -> None:
    """In-place quarter round on rows a,b,c,d of state x [16, nblocks]."""
    x[a] += x[b]
    x[d] = _rotl(x[d] ^ x[a], 16)
    x[c] += x[d]
    x[b] = _rotl(x[b] ^ x[c], 12)
    x[a] += x[b]
    x[d] = _rotl(x[d] ^ x[a], 8)
    x[c] += x[d]
    x[b] = _rotl(x[b] ^ x[c], 7)


def chacha20_blocks(
    key: np.ndarray, counter: int, nonce: np.ndarray, nblocks: int
) -> np.ndarray:
    """ChaCha20 block function (RFC 8439 §2.3) for `nblocks` consecutive
    counters, vectorized: returns uint32 [nblocks, 16].

    key: uint32 [8] (little-endian words of the 256-bit key);
    nonce: uint32 [3]; counter: starting 32-bit block counter.
    """
    x = np.empty((16, nblocks), dtype=np.uint32)
    x[0:4] = _CONST[:, None]
    x[4:12] = np.asarray(key, dtype=np.uint32)[:, None]
    x[12] = (np.uint64(counter) + np.arange(nblocks, dtype=np.uint64)).astype(
        np.uint32
    )
    x[13:16] = np.asarray(nonce, dtype=np.uint32)[:, None]
    w = x.copy()
    for _ in range(10):
        _qr(w, 0, 4, 8, 12)
        _qr(w, 1, 5, 9, 13)
        _qr(w, 2, 6, 10, 14)
        _qr(w, 3, 7, 11, 15)
        _qr(w, 0, 5, 10, 15)
        _qr(w, 1, 6, 11, 12)
        _qr(w, 2, 7, 8, 13)
        _qr(w, 3, 4, 9, 14)
    w += x
    return np.ascontiguousarray(w.T)


class ChaChaGenerator:
    """ChaCha20-backed generator covering the client layer's RNG needs.

    Deterministic in (seed); independent streams via the 96-bit nonce
    (`stream`). The 32-bit block counter bounds one stream at 256 GiB of
    output — far above any keygen/encrypt batch; an assertion guards it.
    """

    def __init__(self, seed: int | bytes | None = None, stream: int = 0):
        if seed is None:
            key_bytes = os.urandom(32)
        else:
            if isinstance(seed, int):
                seed = seed.to_bytes(32, "little", signed=False)
            key_bytes = hashlib.sha256(b"helm_tpu-csprng-v1:" + seed).digest()
        self._key = np.frombuffer(key_bytes, dtype="<u4").copy()
        self._nonce = np.array(
            [stream & 0xFFFFFFFF, (stream >> 32) & 0xFFFFFFFF, (stream >> 64) & 0xFFFFFFFF],
            dtype=np.uint32,
        )
        self._counter = 0
        self._buf = np.empty(0, dtype=np.uint32)

    # -- core stream ----------------------------------------------------
    def random_u32(self, count: int) -> np.ndarray:
        """Next `count` uint32 words of the keystream."""
        out = np.empty(count, dtype=np.uint32)
        take = min(count, self._buf.size)
        if take:
            out[:take] = self._buf[:take]
            self._buf = self._buf[take:]
        need = count - take
        if need > 0:
            nblocks = (need + 15) // 16
            if self._counter + nblocks >= (1 << 32):
                # unconditional (not assert: survives python -O) — past
                # 2^32 blocks the 32-bit counter wraps and the keystream
                # repeats, reusing LWE mask/noise material
                raise RuntimeError(
                    "ChaCha20 stream exhausted (2^32 blocks); "
                    "rekey or use a new stream id"
                )
            words = chacha20_blocks(
                self._key, self._counter, self._nonce, nblocks
            ).reshape(-1)
            self._counter += nblocks
            out[take:] = words[:need]
            self._buf = words[need:]
        return out

    # -- numpy.random.Generator-compatible slice ------------------------
    def bytes(self, length: int) -> bytes:
        return self.random_u32((length + 3) // 4).tobytes()[:length]

    def integers(self, low, high=None, size=None, dtype=np.int64):
        """Uniform integers in [low, high) (numpy Generator convention)."""
        if high is None:
            low, high = 0, low
        low, high = int(low), int(high)
        span = high - low
        assert span > 0, (low, high)
        shape = () if size is None else (
            (size,) if isinstance(size, int) else tuple(size)
        )
        count = int(np.prod(shape, dtype=np.int64)) if shape else 1
        if span & (span - 1) == 0:  # power of two: mask, no rejection
            bits = span.bit_length() - 1
            if bits <= 32:
                v = (
                    self.random_u32(count).astype(np.uint64)
                    & np.uint64(span - 1 if bits < 64 else ~0)
                )
            else:
                w = self.random_u32(2 * count).astype(np.uint64)
                v = (w[0::2] | (w[1::2] << np.uint64(32))) & np.uint64(span - 1)
        else:
            # rejection sampling on the smallest covering power of two
            bits = span.bit_length()
            mask = np.uint64((1 << bits) - 1)
            v = np.empty(count, dtype=np.uint64)
            filled = 0
            while filled < count:
                draw = count - filled
                if bits <= 32:
                    cand = self.random_u32(draw).astype(np.uint64) & mask
                else:
                    w = self.random_u32(2 * draw).astype(np.uint64)
                    cand = (w[0::2] | (w[1::2] << np.uint64(32))) & mask
                cand = cand[cand < span]
                v[filled : filled + cand.size] = cand
                filled += cand.size
        out = (v + np.uint64(low % (1 << 64))).astype(dtype).reshape(shape)
        return out if shape else dtype(out[()])

    def normal(self, loc: float = 0.0, scale: float = 1.0, size=None):
        """Gaussian via Box-Muller over 53-bit uniforms."""
        shape = () if size is None else (
            (size,) if isinstance(size, int) else tuple(size)
        )
        count = int(np.prod(shape, dtype=np.int64)) if shape else 1
        pairs = (count + 1) // 2
        w = self.random_u32(4 * pairs).astype(np.uint64)
        u64 = w[0::2] | (w[1::2] << np.uint64(32))
        # (0, 1] uniforms: 53 mantissa bits, +1 excludes zero for the log
        u = ((u64 >> np.uint64(11)).astype(np.float64) + 1.0) * 2.0**-53
        u1, u2 = u[:pairs], u[pairs:]
        r = np.sqrt(-2.0 * np.log(u1))
        theta = 2.0 * np.pi * u2
        g = np.concatenate([r * np.cos(theta), r * np.sin(theta)])[:count]
        out = (loc + scale * g).reshape(shape)
        return out if shape else float(out[()])


def make_rng(seed: int | None = None):
    """Client-side RNG factory: ChaCha20 CSPRNG by default;
    HELM_TPU_INSECURE_PRNG=1 opts into numpy PCG64 (bench mode)."""
    if os.environ.get("HELM_TPU_INSECURE_PRNG") == "1":
        return np.random.default_rng(seed)
    return ChaChaGenerator(seed)
