"""Key persistence for the port: save / load client and server keys.

Counterpart of `helm_tpu/fhe/keys.py`. The npz format is the reference's
own, so key files written by either package load in the other; the code
is copied here so that the port imports nothing of the JAX package.
`load_or_generate` generates through the port's keygen (`server_key.py`)
with its NTT on `device` (the card by default).
"""

from __future__ import annotations

import os

import numpy as np

from ..params import ALL_PARAMS
from .csprng import make_rng
from .lwe import ClientKey, keygen
from .modring import PRIMES, PRIMES_1024, primes_for
from .server_key import ServerKey, gen_server_key


def save_client_key(path: str, ck: ClientKey) -> None:
    np.savez_compressed(
        path,
        kind="client",
        params=ck.params.name,
        lwe_key=ck.lwe_key,
        glwe_key=ck.glwe_key,
    )


def _params(z, params):
    """The set a key file names: `params` when given (a set outside
    ALL_PARAMS, such as a derived one), which must carry that name."""
    name = str(z["params"])
    if params is None:
        return ALL_PARAMS[name]
    if params.name != name:
        raise ValueError(f"key file is for {name!r}, not {params.name!r}")
    return params


def load_client_key(path: str, params=None) -> ClientKey:
    z = np.load(path, allow_pickle=False)
    assert str(z["kind"]) == "client", "not a client key file"
    params = _params(z, params)
    return ClientKey(params, z["lwe_key"], z["glwe_key"], make_rng())


def save_server_key(path: str, sk: ServerKey) -> None:
    np.savez_compressed(
        path,
        kind="server",
        params=sk.params.name,
        # the BSK is serialized in the NTT/CRT domain, so the file is only
        # valid for the prime set it was built under (modring.primes_for)
        primes=np.asarray(primes_for(sk.params.N), dtype=np.uint32),
        bsk_ntt=sk.bsk_ntt,
        bsk_ntt_sh=sk.bsk_ntt_sh,
        ksk_limbs=sk.ksk_limbs,
    )


def load_server_key(path: str, params=None) -> ServerKey:
    z = np.load(path, allow_pickle=False)
    assert str(z["kind"]) == "server", "not a server key file"
    params = _params(z, params)
    want = np.asarray(primes_for(params.N), dtype=np.uint32)
    if "primes" in z.files:
        got = z["primes"]
    else:  # files that recorded no prime set: the legacy mapping
        got = np.asarray(PRIMES_1024 if params.N <= 1024 else PRIMES, dtype=np.uint32)
    if not np.array_equal(got, want):
        raise ValueError(
            f"{path}: server key was built under CRT primes "
            f"{got.tolist()} but this build uses {want.tolist()} for "
            f"N={params.N} — regenerate the key"
        )
    ksk = z["ksk_limbs"]
    want_rows = params.big_n * params.ks_level
    if ksk.shape[1] != want_rows:
        raise ValueError(
            f"{path}: KSK has {ksk.shape[1]} decomposition rows but "
            f"params '{params.name}' expect big_n*ks_level = {want_rows} "
            f"(keyswitch geometry changed) — regenerate the key"
        )
    return ServerKey(params, z["bsk_ntt"], z["bsk_ntt_sh"], ksk)


def load_or_generate(dir_path: str, params, seed=None, device="cuda"):
    """Load (client, server) keys for `params` from dir_path when present,
    else generate them (NTT on `device`) and save them there."""
    os.makedirs(dir_path, exist_ok=True)
    ckp = os.path.join(dir_path, f"ck_{params.name}.npz")
    skp = os.path.join(dir_path, f"sk_{params.name}.npz")
    if os.path.exists(ckp) and os.path.exists(skp):
        try:
            return load_client_key(ckp), load_server_key(skp)
        except ValueError as e:  # e.g. CRT prime set changed
            # park the stale pair (never overwrite a client key in place)
            idx = 0
            while os.path.exists(f"{ckp}.stale-{idx}") or os.path.exists(
                f"{skp}.stale-{idx}"
            ):
                idx += 1
            for p_ in (ckp, skp):
                if os.path.exists(p_):
                    os.replace(p_, f"{p_}.stale-{idx}")
            print(
                f"[keys] cached keys invalid ({e}); regenerating — old "
                f"keys kept as *.stale-{idx}"
            )
    ck = keygen(params, seed)
    sk = gen_server_key(ck, device)
    save_client_key(ckp, ck)
    save_server_key(skp, sk)
    return ck, sk
