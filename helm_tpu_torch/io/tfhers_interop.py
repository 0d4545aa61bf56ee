"""tfhe-rs wire-format interop: raw-LWE interchange files.

The port's own copy of `helm_tpu/io/tfhers_interop.py`: the same npz
format, so a file written by either package loads in the other
(tests/test_torch_interop.py).

The reference's crypto layer is tfhe-rs 0.4 (reference: Cargo.toml:18);
its boolean mode runs LWE over q = 2^32 with the same +-q/8 encoding this
repo uses (reference: src/circuit.rs:29-33 documents the identical
encoding for the GPU engine; tfhe-rs boolean uses 1/8 vs -1/8 on the
torus). Mathematically, a tfhe-rs boolean ciphertext and a helm_tpu_torch
gates-mode ciphertext are the SAME object: a uint32 vector
[a_0..a_{n-1}, b] with b = <a, s> + mu + e mod 2^32.

Rather than re-implementing tfhe-rs's bincode struct layout (version-
fragile and untestable without the library), interop uses a trivial raw
interchange format that tfhe-rs itself can produce/consume via its public
container accessors — the Rust side is pinned in tools/tfhers_interop/
(10 lines per direction, using `LweCiphertext::from_container` /
`.into_container()`). Cross-implementation vectors then replay through
either stack:

  tfhe-rs encrypt -> export_raw -> helm_tpu_torch evaluate -> decrypt   (and
  helm_tpu_torch encrypt -> import into tfhe-rs -> ServerKey::and -> decrypt)

File format (.npz, all little-endian):
  header:  int64 [version=1, n, q_log2, msg_space_log]
  cts:     uint32 [num_cts, n+1]   mask columns 0..n-1, body column n
  key:     uint32 [n]              optional (secret interchange only)
"""

from __future__ import annotations

import numpy as np

from ..params import TfheParams

VERSION = 1


def save_lwe(path: str, params: TfheParams, cts: np.ndarray,
             key: np.ndarray | None = None) -> None:
    """Write ciphertexts (uint32 [..., n+1]) to the interchange format."""
    cts = np.asarray(cts, dtype=np.uint32)
    assert cts.shape[-1] == params.n + 1, (cts.shape, params.n)
    payload = {
        "header": np.array(
            [VERSION, params.n, 32, params.msg_space_log], dtype=np.int64
        ),
        "cts": cts.reshape(-1, params.n + 1),
    }
    if key is not None:
        key = np.asarray(key, dtype=np.uint32)
        assert key.shape == (params.n,)
        payload["key"] = key
    np.savez(path, **payload)


def load_lwe(path: str, params: TfheParams | None = None):
    """Read an interchange file -> (cts uint32 [M, n+1], key or None,
    header dict). Validates the dimension against `params` when given."""
    z = np.load(path, allow_pickle=False)
    v, n, qlog, msl = (int(x) for x in z["header"])
    if v != VERSION:
        raise ValueError(f"unsupported interchange version {v}")
    if qlog != 32:
        raise ValueError(f"q=2^{qlog} not supported (expect 2^32)")
    cts = z["cts"].astype(np.uint32)
    if cts.ndim != 2 or cts.shape[1] != n + 1:
        raise ValueError(f"ciphertext shape {cts.shape} != [M, {n + 1}]")
    if params is not None and n != params.n:
        raise ValueError(f"dimension mismatch: file n={n}, params n={params.n}")
    key = z["key"].astype(np.uint32) if "key" in z else None
    return cts, key, {"n": n, "q_log2": qlog, "msg_space_log": msl}


def export_client(path: str, ck, cts: np.ndarray, include_key: bool = False):
    """Export helm_tpu_torch ciphertexts (and optionally the small LWE key) for
    replay through tfhe-rs (see tools/tfhers_interop/)."""
    save_lwe(path, ck.params, cts, ck.lwe_key if include_key else None)
