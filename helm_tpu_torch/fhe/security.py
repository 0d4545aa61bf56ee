"""First-order LWE concrete-security estimator (primal uSVP, core-SVP).

The reference hard-codes its parameter sets and cites external
lattice-estimator runs (reference: src/bin/helm.rs:141-146 and the
concrete-core Boolean parameter lineage); this repo cannot reach the
maintained estimator (zero egress), so this module implements the standard
first-order estimate in-repo and CI pins every production set against it
(tests/test_params_keys.py).

Method — primal uSVP with the "2016 estimate" (Alkim-Ducas-Poppelmann-
Schwabe; the same first-order model the lattice estimator's `usvp` entry
refines):

  For LWE with dimension n, modulus q, error std sigma_e and a *binary*
  secret, the Bai-Galbraith rescaling embeds the secret coordinates at
  scale xi = sigma_e / sigma_s (sigma_s = 1/2 for uniform {0,1}).  Using m
  samples, the attack lattice has dimension d = n + m + 1 and volume
  q^m * xi^n.  BKZ with block size beta recovers the unusually-short
  embedding vector when

      sigma_e * sqrt(beta)  <=  delta(beta)^(2*beta - d - 1) * Vol^(1/d)

  with the root-Hermite factor delta(beta) =
  ((beta / (2*pi*e)) * (pi*beta)^(1/beta))^(1 / (2*(beta-1))).

  The attack cost is the core-SVP model: 2^(0.292*beta) classical sieving
  (2^(0.265*beta) quantum), ignoring polynomial factors and BKZ calls —
  i.e. a *conservative lower bound* on attacker cost, the convention used
  by NIST-PQC submissions.  We minimize beta over the number of samples m.

GLWE keys are treated as LWE instances of dimension k*N with the GLWE
noise (standard reduction; ring structure gives no known advantage for
these parameters).

Caveats (documented, deliberate):
- Hybrid lattice/meet-in-the-middle and recent dual-sieve attacks can
  shave a few bits for sparse secrets; our secrets are dense binary, where
  primal uSVP is the canonical headline number.
- This is a first-order model: numbers agree with published
  lattice-estimator runs to within ~2-4 bits in this (q = 2^32,
  n = 512-2048) regime.

The port's own copy of `helm_tpu/fhe/security.py`, so that
helm_tpu_torch imports nothing of the JAX package; the tests/test_torch_*.py
files hold it against the original. `python -m helm_tpu_torch.fhe.security`
prints the core-SVP table of every production set, as the original does.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

from ..params import Q, TfheParams


def bkz_delta(beta: float) -> float:
    """Root-Hermite factor of BKZ with block size beta (beta >= 50)."""
    return ((beta / (2.0 * math.pi * math.e)) * (math.pi * beta) ** (1.0 / beta)) ** (
        1.0 / (2.0 * (beta - 1.0))
    )


def _usvp_beta_for_m(n: int, q: float, sigma_e: float, xi: float, m: int) -> float | None:
    """Smallest BKZ block size that solves uSVP with m samples, or None."""
    d = n + m + 1
    log_vol = m * math.log2(q) + n * math.log2(xi)
    lo, hi = 50, 1500
    # success condition in log2: log2(sigma_e) + 0.5*log2(beta)
    #   <= (2*beta - d - 1) * log2(delta) + log_vol / d

    def ok(beta: int) -> bool:
        lhs = math.log2(sigma_e) + 0.5 * math.log2(beta)
        rhs = (2.0 * beta - d - 1.0) * math.log2(bkz_delta(beta)) + log_vol / d
        return lhs <= rhs

    if not ok(hi):
        return None
    while lo < hi:
        mid = (lo + hi) // 2
        if ok(mid):
            hi = mid
        else:
            lo = mid + 1
    return float(lo)


@dataclass(frozen=True)
class SecurityEstimate:
    n: int
    sigma: float
    beta: float  # optimal BKZ block size (primal uSVP)
    m: int  # optimal number of samples
    classical_bits: float  # 0.292 * beta
    quantum_bits: float  # 0.265 * beta


def estimate_lwe_security(
    n: int, sigma: float, q: int = Q, secret_std: float = 0.5
) -> SecurityEstimate:
    """Primal-uSVP core-SVP estimate for binary-secret LWE over q.

    sigma is the absolute error std in q units (ticks). A noiseless test
    set (sigma = 0) returns 0 bits.
    """
    if sigma <= 0:
        return SecurityEstimate(n, sigma, 0.0, 0, 0.0, 0.0)
    xi = max(sigma / secret_std, 1.0)  # Bai-Galbraith rescaling
    best: tuple[float, int] | None = None
    # m = n..3n covers the optimum for every set we use
    for m in range(max(n // 2, 64), 3 * n + 1, 8):
        beta = _usvp_beta_for_m(n, float(q), sigma, xi, m)
        if beta is not None and (best is None or beta < best[0]):
            best = (beta, m)
    if best is None:
        return SecurityEstimate(n, sigma, math.inf, 0, math.inf, math.inf)
    beta, m = best
    return SecurityEstimate(n, sigma, beta, m, 0.292 * beta, 0.265 * beta)


def estimate_params(p: TfheParams) -> dict[str, SecurityEstimate]:
    """Security of both keys of a parameter set (LWE + GLWE-as-LWE)."""
    return {
        "lwe": estimate_lwe_security(p.n, p.lwe_noise_std),
        "glwe": estimate_lwe_security(p.k * p.N, p.glwe_noise_std),
    }


def security_bits(p: TfheParams) -> float:
    """Headline classical security = min over both keys."""
    est = estimate_params(p)
    return min(est["lwe"].classical_bits, est["glwe"].classical_bits)


def report(params_list) -> str:
    lines = [
        f"{'set':<18} {'key':<5} {'n':>5} {'sigma':>8} {'beta':>6} "
        f"{'m':>5} {'classical':>9} {'quantum':>8}"
    ]
    for p in params_list:
        for key, e in estimate_params(p).items():
            lines.append(
                f"{p.name:<18} {key:<5} {e.n:>5} {e.sigma:>8.3g} {e.beta:>6.0f} "
                f"{e.m:>5} {e.classical_bits:>9.1f} {e.quantum_bits:>8.1f}"
            )
    return "\n".join(lines)


if __name__ == "__main__":
    from ..params import ALL_PARAMS

    prod = [p for p in ALL_PARAMS.values() if not p.name.startswith("test_")]
    print(report(prod))
