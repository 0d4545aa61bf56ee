"""Search the TFHE parameter space for the cheapest >=104-bit core-SVP
gates-mode set under a cost model of K1 on an H100.

Counterpart of `tools/param_search.py`. The security bar, the noise bar,
the candidate loops and the pick per (N, k, g) are the reference's,
against the port's own copies (`params.TfheParams.pbs_failure_log2`,
`fhe/security.py estimate_lwe_security`): both keys >= SEC_BITS classical
core-SVP bits, the GLWE sigma floored at 4 ticks, `pbs_failure_log2` at
linear growth 8 <= FAIL_BITS, and for each (n, l) the first base that
meets the bar.

The cost is K1's blind rotation on the card, not the TPU kernel's stage
map. Per step (a group of g mask elements) and gate, K1 does
  butterflies   (rows + k+1) NP (N/2) log2 N   the decomposition with the
                first pass, the other forward passes, the inverse passes
  multiply-adds ((2^g-1) rows (k+1) + (2^g-1) (k+1)) NP N   the products
                against the BSK and by the subset polynomials (P_1 = X^a -
                1 at g = 1)
  rest          (k+1) N   Garner and the two cluster barriers
(the units chip_smoke.py `int_ops` counts), and the clocks of each phase
(`tools/k1_phases.py`, a group's clocks of one cluster's tile, divided by
its gt gates) are fitted to them by least squares through the origin
(`fit`): one coefficient for the butterflies, one for the rest, and one
for the multiply-adds of each of K1's two builds, the narrow one (u32
sums, a u16 BSK: `mb_pbs.fits_u32`) and the wide one (u64 sums), whose
clocks a multiply-add differ twofold on the card. The cost of a set is
n/g steps of that; the predicted rate is MEAS x cost(GATES_128_K3) /
cost(p), MEAS being K1's measured rot/s at GATES_128_K3, G = 1024, in the
chip call the fit came from.

    python -m helm_tpu_torch.tools.param_search                # host only
    python -m helm_tpu_torch.tools.param_search --measure 3    # and the card
    python -m helm_tpu_torch.tools.param_search --fit LOG ...  # refit

Prints the reference's table, one row per (N, k, g), with a column `k1`:
whether K1 has a build for the row's (g, gadget rows) (`mb_pbs.K1_BUILDS`).
`--measure K` makes keys for the first K rows K1 has a build for and
times K1 on them at G = 1024 AND gates, decrypt-checked (`--device`,
default cuda), printing predicted against measured rot/s. `--fit` reads
k1_phases' RESULT lines from logs (`tools/collect_results.py`) and prints
the coefficients and the residuals, for the constants below.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from dataclasses import replace

import torch

from .. import params as P
from ..fhe.security import estimate_lwe_security
from ..ops import mb_pbs
from ..params import TfheParams
from .g1_fs_test import check_ands
from .mb_sweep import inputs

SEC_BITS = 104.0
FAIL_BITS = -32.0
LINEAR_GROWTH = 8.0  # XOR doubling, the worst gates-mode linear combination
NP = 4  # CRT primes
G_MEASURE = 1024

#: clocks a gate-step per unit (butterfly; multiply-add of the narrow and
#: of the wide build; rest), fitted by `fit` to k1_phases' clocks at the
#: widest width of GATES_128_K3 (g = 2 and g = 1: narrow), LUT_128_K2 and
#: ARITH_128_MB2 (wide) (`--fit` on that run's log), and MEAS, K1's rot/s
#: at GATES_128_K3, G = 1024 (CUDA events over 6 calls, chip_smoke.py
#: `_g1_ab`), from the same run on an NVIDIA H100 80GB HBM3 at 700.00 W
#: (PERF.md section 6). Residuals (model against measured): the
#: narrow multiply-adds -43% at g = 1 (the gadget rows' loads and the
#: power-table lookups a step do not halve with the subsets) and +9% at
#: g = 2, the wide ones +12% (LUT_128_K2) and -11% (ARITH_128_MB2), the
#: butterflies and the rest within 9%
A_BFLY = 0.04707969282940785
B_MULADD_U32 = 0.025590292612711583
B_MULADD_U64 = 0.05493572377401635
C_REST = 0.9179615999918789
MEAS = 13992.733219121932


def units(p: TfheParams) -> tuple[int, int, int]:
    """K1's work a step and gate at p: (butterflies, multiply-adds, rest)."""
    N, kp1, rows, nv1 = p.N, p.k + 1, p.gadget_rows, (1 << p.grouping) - 1
    bfly = (rows + kp1) * NP * (N // 2) * int(math.log2(N))
    muladd = (nv1 * rows * kp1 + nv1 * kp1) * NP * N
    return bfly, muladd, kp1 * N


def cost(p: TfheParams, coef=None) -> float:
    """The model's clocks for one gate's rotation at p: n/g steps."""
    a, b32, b64, c = coef or (A_BFLY, B_MULADD_U32, B_MULADD_U64, C_REST)
    ub, um, ur = units(p)
    return (p.n // p.grouping) * (a * ub + (b32 if mb_pbs._narrow(p) else b64) * um + c * ur)


def predicted(p: TfheParams) -> float:
    """The model's rot/s at p, normalised to MEAS at GATES_128_K3."""
    return MEAS * cost(P.GATES_128_K3) / cost(p)


def has_build(p: TfheParams) -> bool:
    """Whether K1 has a template build for p's (grouping, gadget rows)."""
    return (p.grouping, p.gadget_rows) in mb_pbs.K1_BUILDS


_sig_cache: dict = {}


def min_sigma(dim: int) -> float:
    """Smallest noise std (q ticks) giving >= SEC_BITS for dimension dim."""
    if dim in _sig_cache:
        return _sig_cache[dim]
    lo, hi = -6.0, 16.0  # log2 sigma
    if estimate_lwe_security(dim, 2.0**hi).classical_bits < SEC_BITS:
        _sig_cache[dim] = float("inf")
        return _sig_cache[dim]
    for _ in range(30):
        mid = (lo + hi) / 2
        if estimate_lwe_security(dim, 2.0**mid).classical_bits >= SEC_BITS:
            hi = mid
        else:
            lo = mid
    _sig_cache[dim] = 2.0**hi
    return _sig_cache[dim]


def candidates(Ns=(512, 1024, 2048), ks=(1, 2, 3, 4), n_lo: int = 576, n_hi: int = 900) -> list:
    """The reference's candidates before the pick, in its loop order:
    (failure log2, set) for each (N, k, g, n, l) with its first base that
    meets the noise bar."""
    cands = []
    for N in Ns:
        for k in ks:
            if k * N > 4096 or (k > 1 and N == 2048):
                continue
            # floor 4 ticks: a discrete Gaussian needs sigma >= ~4 for the
            # continuous-model security estimate to apply
            sg = max(min_sigma(k * N), 4.0)
            if not math.isfinite(sg):
                continue
            for g in (1, 2):
                for n_dim in range(n_lo, n_hi, 2 if g == 2 else 1):
                    if n_dim % g:
                        continue
                    sl = min_sigma(n_dim)
                    if not math.isfinite(sl):
                        continue
                    for lv in (1, 2, 3):
                        for bl in range(6, 24):
                            if bl * lv > 34:
                                continue
                            p = TfheParams(
                                name=f"cand_n{n_dim}_k{k}_N{N}_b{bl}_l{lv}_g{g}",
                                n=n_dim, k=k, N=N,
                                pbs_base_log=bl, pbs_level=lv,
                                ks_base_log=1, ks_level=14,
                                lwe_noise_std=sl, glwe_noise_std=sg,
                                msg_space_log=3, message_bits=1, grouping=g,
                            )
                            f = p.pbs_failure_log2(linear_growth=LINEAR_GROWTH)
                            if f <= FAIL_BITS:
                                cands.append((f, p))
                                break  # the cost is base-independent; any base works
    return cands


def pick(cands) -> list:
    """The cheapest candidate of each (N, k, g), cheapest first:
    (cost, failure log2, set)."""
    ranked = sorted(((cost(p), f, p) for f, p in cands), key=lambda t: t[0])
    seen, out = set(), []
    for c, f, p in ranked:
        key = (p.N, p.k, p.grouping)
        if key not in seen:
            seen.add(key)
            out.append((c, f, p))
    return out


def table(rows) -> str:
    """The reference's table and the `k1` column."""
    base = cost(P.GATES_128_K3)
    lines = [f"{'name':<34}{'cost_x':>7}{'pred_bs/s':>10}{'fail2^':>8}{'lwe_sig':>9}{'glwe_sig':>9}{'k1':>5}"]
    for c, f, p in rows:
        lines.append(f"{p.name:<34}{c / base:>7.2f}{MEAS * base / c:>10.0f}{f:>8.1f}"
                     f"{p.lwe_noise_std:>9.3g}{p.glwe_noise_std:>9.3g}{'yes' if has_build(p) else 'no':>5}")
    return "\n".join(lines)


#: k1_phases' phases by the unit they are fitted to (butterflies,
#: multiply-adds, rest)
PHASE_UNIT = {"decompose+pass1": 0, "fwd passes": 0, "inv passes": 0, "products": 1,
              "cluster sync 1": 2, "garner": 2, "cluster sync 2": 2}
#: the coefficients' names, in `cost`'s order
KINDS = ("bfly", "muladd u32", "muladd u64", "rest")


def fit(results) -> dict:
    """Least squares through the origin, one coefficient per kind (KINDS):
    each width's clocks a gate-step of the phases of that kind (k1_phases'
    clocks a group / its tile's gt) against the kind's units, the
    multiply-adds apart for the narrow and the wide build. `results`:
    k1_phases RESULT dicts; K1's widest width of each set and grouping
    enters. Returns {"coef": (a, b32, b64, c), "rows": [{set, grouping,
    G, kind, measured, model} per width and unit]}."""
    widest = {}
    for r in results:
        if r.get("tool") == "k1_phases" and r.get("kernel") == "mb":
            key = (r["set"], r["grouping"])
            if key not in widest or r["G"] > widest[key]["G"]:
                widest[key] = r
    pts = []  # (kind, unit count, clocks a gate-step, result)
    for r in widest.values():
        p = P.ALL_PARAMS.get(r["set"]) or replace(
            P.ALL_PARAMS[r["set"].removesuffix(f"_g{r['grouping']}")], name=r["set"], grouping=r["grouping"])
        u = units(p)
        got = [0.0, 0.0, 0.0]
        for phase, clk in r["clocks"].items():
            got[PHASE_UNIT[phase]] += clk / r["gt"]
        kinds = (0, 1 if mb_pbs._narrow(p) else 2, 3)
        pts += [(kinds[i], u[i], got[i], r) for i in range(3)]
    coef = []
    for kind in range(len(KINDS)):
        xs = [(x, y) for k_, x, y, _ in pts if k_ == kind]
        if not xs:
            raise ValueError(f"fit: no width gives the {KINDS[kind]} coefficient")
        coef.append(sum(x * y for x, y in xs) / sum(x * x for x, _ in xs))
    rows = [{"set": r["set"], "grouping": r["grouping"], "G": r["G"], "kind": KINDS[k_],
             "measured": y, "model": coef[k_] * x} for k_, x, y, r in pts]
    return {"coef": tuple(coef), "rows": rows}


def measure(p: TfheParams, ck, dsk, G: int = G_MEASURE, iters: int = 6) -> float:
    """K1's rot/s at p over `iters` rotations of G AND gates (after one
    that is decrypt-checked when p is a gates-mode set)."""
    x, tv = inputs(ck, G, dsk.device)
    acc = mb_pbs.blind_rotate_mb(dsk, x, tv)
    if p.msg_space_log == 3 and p.message_bits == 1:
        check_ands(ck, acc, f"{p.name} K1")

    def sync():
        if dsk.device.type == "cuda":
            torch.cuda.synchronize(dsk.device)

    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        mb_pbs.blind_rotate_mb(dsk, x, tv)
    sync()
    return G * iters / (time.perf_counter() - t0)


def compare(p: TfheParams, ck, dsk, G: int = G_MEASURE) -> dict:
    """Predicted against measured rot/s at p; prints and returns a RESULT
    dict (err: measured / predicted - 1)."""
    got = measure(p, ck, dsk, G)
    pred = predicted(p)
    res = {"tool": "param_search", "set": p.name, "G": G, "pred_rot_s": pred, "rot_s": got,
           "err": got / pred - 1.0}
    print("RESULT " + json.dumps(res), flush=True)
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--measure", type=int, default=0, metavar="K",
                    help="time K1 on the card at the first K rows with a build (default 0: host only)")
    ap.add_argument("--device", default="cuda", help="torch device for --measure (default cuda)")
    ap.add_argument("--fit", nargs="+", metavar="LOG", help="refit the model to k1_phases RESULT lines")
    args = ap.parse_args(argv)
    if args.fit:
        from .collect_results import collect

        out = fit(collect(args.fit)["results"])
        print("A_BFLY, B_MULADD_U32, B_MULADD_U64, C_REST = " + ", ".join(repr(c) for c in out["coef"]))
        for r in out["rows"]:
            print(f"{r['set']} g={r['grouping']} G={r['G']} {r['kind']}: {r['measured']:.2f} clocks a gate-step, "
                  f"model {r['model']:.2f} ({100 * (r['model'] / r['measured'] - 1):+.1f}%)")
        return 0
    rows = pick(candidates())
    print(table(rows), flush=True)
    if args.measure:
        from ..fhe import lwe, pbs
        from ..fhe.server_key import gen_server_key

        device = torch.device(args.device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise SystemExit(f"--device {args.device}: no CUDA device is available")
        for _, _, p in [r for r in rows if has_build(r[2])][: args.measure]:
            ck = lwe.keygen(p, 7)
            dsk = pbs.DeviceServerKey.from_host(gen_server_key(ck, device), device)
            r = compare(p, ck, dsk)
            print(f"{p.name}: predicted {r['pred_rot_s']:.0f} rot/s, measured {r['rot_s']:.0f} "
                  f"({100 * r['err']:+.1f}%)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
