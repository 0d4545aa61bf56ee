"""Key persistence for the port.

Counterpart of `helm_tpu/fhe/keys.py:87` `load_or_generate`: loading and
saving are the reference's own (numpy npz files, shared by both
packages); generation goes through the port's keygen (`server_key.py`)
with its NTT on `device`.
"""

from __future__ import annotations

import os

from helm_tpu.fhe import keys as ref_keys
from helm_tpu.fhe.lwe import keygen

from .server_key import gen_server_key


def load_or_generate(dir_path: str, params, seed=None, device="cpu"):
    """Load (client, server) keys for `params` from dir_path when present,
    else generate them (NTT on `device`) and save them there."""
    os.makedirs(dir_path, exist_ok=True)
    ckp = os.path.join(dir_path, f"ck_{params.name}.npz")
    skp = os.path.join(dir_path, f"sk_{params.name}.npz")
    if os.path.exists(ckp) and os.path.exists(skp):
        try:
            return ref_keys.load_client_key(ckp), ref_keys.load_server_key(skp)
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
    ref_keys.save_client_key(ckp, ck)
    ref_keys.save_server_key(skp, sk)
    return ck, sk
