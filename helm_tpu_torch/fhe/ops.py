"""Shared TFHE primitives on torch word tensors.

Counterpart of `helm_tpu/fhe/ops.py`: gadget decomposition, negacyclic
rotation, mod-switch and sample extract. Words are int64 values in
[0, 2^32) (see `fhe/ntt.py`), so the reference's logical right shifts are
plain `>>` here and every wrapping result is masked with `M32`.
"""

from __future__ import annotations

import torch

from .ntt import M32


def signed_decompose(v: torch.Tensor, base_log: int, levels: int) -> torch.Tensor:
    """Signed gadget decomposition of words (ops.py:12 in helm_tpu).

    Returns int64 digits [levels, ...v.shape], level 0 most significant,
    each digit in [-B/2, B/2]."""
    total = base_log * levels
    assert total < 32
    b = 1 << base_log
    half = b // 2
    r = ((v >> (32 - total - 1)) + 1) >> 1
    r = r & ((1 << total) - 1)
    digits = []
    for _ in range(levels):
        d = r & (b - 1)
        carry = d >= half
        d = torch.where(carry, d - b, d)
        r = (r >> base_log) + carry.to(r.dtype)
        digits.append(d)
    digits.reverse()  # level 0 = most significant (weight q/B)
    return torch.stack(digits, dim=0)


def negacyclic_rotate(x: torch.Tensor, r: torch.Tensor, N: int) -> torch.Tensor:
    """Multiply [..., N] word polys by X^r, r in [0, 2N), batched.

    `r` must broadcast against x.shape[:-1]. The same barrel rotator as the
    reference: log2(2N) static rolls and selects."""
    log2n = N.bit_length() - 1
    idx = torch.arange(N, device=x.device)
    for s_log in range(log2n):
        s = 1 << s_log
        bit = ((r >> s_log) & 1).to(torch.bool)[..., None]
        rolled = torch.roll(x, s, dims=-1)
        rotated = torch.where(idx < s, (0 - rolled) & M32, rolled)
        x = torch.where(bit, rotated, x)
    bit = ((r >> log2n) & 1).to(torch.bool)[..., None]
    return torch.where(bit, (0 - x) & M32, x)


def mod_switch(v: torch.Tensor, N: int) -> torch.Tensor:
    """Round words to [0, 2N) buckets."""
    lg = N.bit_length()  # log2(2N)
    r = ((v >> (32 - lg - 1)) + 1) >> 1
    return r & (2 * N - 1)


def sample_extract(acc: torch.Tensor, k: int, N: int) -> torch.Tensor:
    """Coefficient 0 of GLWE ctxts as big-LWE rows: [..., k+1, N] -> [..., k*N+1]."""
    mask = acc[..., :k, :]
    a0 = mask[..., 0:1]
    rest = (0 - torch.flip(mask[..., 1:], dims=(-1,))) & M32
    a = torch.cat([a0, rest], dim=-1).reshape(acc.shape[:-2] + (k * N,))
    b = acc[..., k, 0:1]
    return torch.cat([a, b], dim=-1)
