"""TFHE parameter sets for the TPU engine (q = 2^32 everywhere).

The reference hard-codes parameters per mode (reference: src/bin/helm.rs:81-88
arith, :141-146 GPU gates, :241 CPU gates, :301 LUTs). We do the same but all
sets live over q = 2^32 (uint32, the TPU-native word) and carry an explicit
noise model so tests can assert decryption margins.

Security note: the gates-mode set mirrors the reference's GPU engine
(concrete-core boolean: n=512, k=1, N=1024, sigma_glwe = 2.98e-8 of the
torus, PBS decomp (base 2^7, level 3), KS (base 2^2, level 8) — reference:
src/bin/helm.rs:141-146). The other sets are scaled analogously; all are
recorded with their modulus-to-noise gap so they can be re-checked with the
lattice estimator. See SECURITY.md.

The port's own copy of `helm_tpu/params.py`, trimmed to what the port
calls, so that helm_tpu_torch imports nothing of the JAX package; the
tests/test_torch_*.py files hold it against the original.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields

Q = 1 << 32  # ciphertext modulus (uint32 wrapping arithmetic)
Q_MASK = Q - 1


@dataclass(frozen=True)
class TfheParams:
    """One TFHE parameter set (LWE + GLWE + PBS + KS + encoding)."""

    name: str
    n: int  # LWE dimension (small key; ciphertexts the engines carry)
    k: int  # GLWE dimension
    N: int  # polynomial size (power of two, <= 2048)
    pbs_base_log: int  # gadget base B = 2^pbs_base_log for the external product
    pbs_level: int  # gadget levels l
    ks_base_log: int  # keyswitch base
    ks_level: int  # keyswitch levels
    lwe_noise_std: float  # absolute std-dev in q units (ticks of 2^-32 torus)
    glwe_noise_std: float  # absolute std-dev in q units
    # log2 of the number of plaintext slots on the torus *including* the
    # padding bit. Gates mode uses 3 (slots at multiples of q/8, values
    # +-q/8); shortint-style modes use message_bits + carry/padding.
    msg_space_log: int = 3
    # shortint semantics (LUT / arith modes)
    message_bits: int = 1
    # multi-bit PBS grouping factor (1 = standard; g>1 groups g LWE mask
    # elements per blind-rotation step, analog of tfhe-rs
    # PARAM_MULTI_BIT_..._GROUP_3 used by the reference's arith mode,
    # src/bin/helm.rs:81-88). Requires n % grouping == 0.
    grouping: int = 1
    # approximate gadget decomposition (the original TFHE paper's trick):
    # the k GLWE *mask* components of the accumulator may use a wider /
    # shallower gadget than the body — their decomposition residual only
    # enters the noise through the GLWE secret (variance ~ kN * eps_m^2 /24
    # per step), so fewer rows can suffice. None = same gadget as the body.
    # Cuts external-product rows from (k+1)*l to k*l_m + l.
    # EVALUATED AND UNUSED IN PRODUCTION at q=2^32: with the sigma>=4
    # discrete-sampling floor, every production set is already at its noise
    # edge (modswitch + margin), and no (mask_base, mask_level) with fewer
    # rows keeps per-PBS failure under 2^-32 (swept over bases 2^6..2^16,
    # all levels, all nine production sets). The machinery stays (tested in
    # tests/test_multibit.py) because q=2^64-limb sets would afford it.
    pbs_mask_base_log: int | None = None
    pbs_mask_level: int | None = None

    @property
    def mask_base_log(self) -> int:
        return self.pbs_mask_base_log or self.pbs_base_log

    @property
    def mask_level(self) -> int:
        return self.pbs_mask_level or self.pbs_level

    @property
    def component_gadgets(self) -> tuple:
        """Per-GLWE-component (base_log, levels): k mask rows then body."""
        return tuple(
            [(self.mask_base_log, self.mask_level)] * self.k
            + [(self.pbs_base_log, self.pbs_level)]
        )

    @property
    def gadget_rows(self) -> int:
        """Total external-product rows: k*mask_level + pbs_level."""
        return self.k * self.mask_level + self.pbs_level

    @property
    def big_n(self) -> int:
        """Dimension of the extracted LWE ciphertext (k*N)."""
        return self.k * self.N

    @property
    def delta(self) -> int:
        """Encoding scale: distance between adjacent plaintext slots."""
        return Q >> self.msg_space_log

    @property
    def msg_space(self) -> int:
        return 1 << self.msg_space_log

    @property
    def pbs_base(self) -> int:
        return 1 << self.pbs_base_log

    @property
    def ks_base(self) -> int:
        return 1 << self.ks_base_log

    # ------------------------------------------------------------------
    # Noise model (variance propagation, all in q^2 units).
    # ------------------------------------------------------------------
    def var_fresh_lwe(self) -> float:
        return self.lwe_noise_std**2

    def var_pbs_out(self) -> float:
        """Variance of the LWE(big_n) ciphertext after one blind rotation.

        Standard TFHE external-product analysis: n CMux steps, each adding
        (k+1) * l * N * (B^2/12) * sigma_bsk^2 from the gadget products plus
        the decomposition-rounding tail (q/B^l rounding error times the
        secret), for binary secrets.

        Single-bit (g = 1): the implementation decomposes (X^a - 1)*acc
        (pbs_jnp.blind_rotate computes rot - acc BEFORE decompose_glwe),
        so digit magnitudes are gadget-bounded regardless of the rotation
        and NO polynomial-norm factor applies: per-step scale 1. Pinned
        empirically (tests/test_params_keys.py ratio ~1.03 at GATES_PARAMS,
        which is >99% pbs-variance).

        Multi-bit (grouping g > 1): n/g steps; each step's effective GGSW is
        sum_v P_v (.) BSK_v over the 2^g-1 nonempty subsets, P_v =
        prod_{i in v}(X^{a_i}-1) with squared 2-norm 2^|v|. Unlike the
        single-bit path, the kernels decompose the BARE accumulator and
        apply P_v AFTER the gadget product (the NTT-domain pva multiply in
        ops/mxu_pbs.py / pbs_jnp.blind_rotate_multibit), so each subset's
        noise term carries its full ||P_v||_2^2: per-step scale
        sum_j C(g,j) 2^j = 3^g - 1, total multiplier (3^g - 1)/g vs
        single-bit. (An earlier revision normalized this by the g=1 norm
        factor 2 that the g=1 form does not actually pay; the 2^20-sample
        on-chip measurement at GATES_128_K3 — SECURITY.md noise validation,
        2026-08-20 — pinned the corrected scale.) The rounding tail is one
        acc decomposition per step, so it shrinks by g.

        Digit second moment: signed_decompose yields digits uniform on
        {-B/2..B/2-1}, E[d^2] = (B^2+2)/12 exactly (measured 1.500 at B=4),
        not the continuous-uniform B^2/12.

        The kernels use the additive-identity CMux form (the empty-subset
        GGSW of 1 is never keyed or multiplied — server_key.py), so the
        model's exclusion of a v=0 noise term matches the implementation
        exactly.
        """
        g = self.grouping
        mb_scale = 1.0 if g == 1 else (3.0**g - 1.0) / g
        # sum of E[d^2]*B_r^2-style digit moments over all gadget rows
        # (mask rows may use a wider, shallower approximate gadget —
        # component_gadgets); exact discrete moment (B^2+2)/12 per level
        sum_b2 = sum(
            lv * (float(1 << bl) ** 2 + 2.0)
            for bl, lv in self.component_gadgets
        )
        main = (
            self.n
            * mb_scale
            * self.N
            * (sum_b2 / 12.0)
            * (self.glwe_noise_std**2)
        )
        # decomposition-rounding residual: the body residual enters
        # directly; each mask residual enters through the GLWE secret
        # (N coefficients, binary)
        eps_b = float(Q) / (float(self.pbs_base) ** self.pbs_level)
        eps_m = float(Q) / (float(1 << self.mask_base_log) ** self.mask_level)
        tail = (
            (self.n / g)
            * (eps_b**2 + self.k * self.N * eps_m**2)
            / 24.0
        )
        return main + tail

    def var_ks(self) -> float:
        """Variance added by the big_n -> n keyswitch.

        Each of the big_n * l decomposition digits multiplies a fresh KSK
        noise sample: var = big_n * l * E[d^2] * sigma^2 with the exact
        discrete digit moment E[d^2] = (B^2+2)/12 (signed_decompose digits
        are uniform on {-B/2..B/2-1}; measured 1.500 at B=4 — an earlier
        revision omitted this factor and understated the KS variance 1.5x,
        caught by the 2^20-sample on-chip validation at GATES_128_K3).
        """
        dig2 = (float(self.ks_base) ** 2 + 2.0) / 12.0
        main = self.big_n * self.ks_level * dig2 * (self.lwe_noise_std**2)
        eps = float(Q) / (float(self.ks_base) ** self.ks_level)
        tail = self.big_n * (eps**2) / 24.0
        return main + tail

    def var_modswitch(self) -> float:
        """Phase variance added by switching the mask to 2N buckets."""
        step = float(Q) / (2.0 * self.N)
        return (step**2) * (self.n + 1) / 12.0

    def pbs_failure_log2(self, linear_growth: float = 1.0) -> float:
        """log2 of per-PBS failure probability.

        The decision margin is half a slot (q / 2^(msg_space_log+1)).
        `linear_growth` scales the ciphertext variance for linear combos done
        between bootstraps (e.g. 8 for XOR's doubling, or LUT packing).
        """
        var = (self.var_pbs_out() + self.var_ks()) * linear_growth
        var += self.var_modswitch()
        sigma = math.sqrt(var)
        margin = float(Q) / float(1 << (self.msg_space_log + 1))
        x = margin / (sigma * math.sqrt(2.0))
        # log2(erfc(x)) ~ -x^2/ln(2) - log2(x*sqrt(pi)) for large x
        if x > 3.0:
            return -(x * x) / math.log(2.0) - math.log2(x * math.sqrt(math.pi))
        return math.log2(max(math.erfc(x), 1e-300))

    def conv_bound(self) -> int:
        """Exact worst-case |coefficient| of one step's summed external
        product as an integer (pre-CRT-reconstruction): the CRT prime
        product must exceed 2x this for residues to determine the value
        (modring.primes_for; asserted at keygen). Multibit form:
        sum_v ||P_v||_1 = 3^g - 1 subset-polynomial mass, times the
        per-row digit bound sum, times the N-term convolution against
        balanced (<= q/2) BSK coefficients."""
        digit_sum = sum(
            lv * (1 << (bl - 1)) for bl, lv in self.component_gadgets
        )
        subset_mass = max(3**self.grouping - 1, 1)
        return subset_mass * digit_sum * self.N * (Q // 2)

    def security_gap_bits(self) -> tuple[float, float]:
        """(LWE, GLWE) modulus-to-noise gaps log2(q/sigma) — smaller = harder."""
        return (
            32.0 - math.log2(max(self.lwe_noise_std, 2.0**-4)),
            32.0 - math.log2(max(self.glwe_noise_std, 2.0**-4)),
        )


# ----------------------------------------------------------------------
# Production sets
# ----------------------------------------------------------------------

#: Boolean gates mode. Mirrors the parameters of the reference's GPU engine
#: (reference: src/bin/helm.rs:141-146): sigma = 2.98e-8 * 2^32 ~= 128.
GATES_PARAMS = TfheParams(
    name="gates_v32",
    n=512,
    k=1,
    N=1024,
    pbs_base_log=7,
    pbs_level=3,
    ks_base_log=2,
    ks_level=8,
    lwe_noise_std=128.0,
    glwe_noise_std=128.0,
    msg_space_log=3,
    message_bits=1,
)

#: LUTs mode, 3-bit message space (supports 2- and 3-input LUTs; analog of
#: tfhe-rs PARAM_MESSAGE_2_CARRY_1 used at reference tests/circuit_test.rs:287
#: and PARAM_MESSAGE_1_CARRY_1 at src/bin/helm.rs:301).
LUT_PARAMS = TfheParams(
    name="lut3_v32",
    n=700,
    k=1,
    N=2048,
    pbs_base_log=8,
    pbs_level=3,
    ks_base_log=2,
    ks_level=8,
    lwe_noise_std=64.0,
    glwe_noise_std=4.0,
    msg_space_log=4,  # 3 usable message bits + padding bit
    message_bits=3,
)

#: Arithmetic mode blocks: 2-bit message + 2-bit carry + padding (analog of
#: tfhe-rs PARAM_MULTI_BIT_MESSAGE_2_CARRY_2_GROUP_3_KS_PBS at
#: src/bin/helm.rs:81-88).
ARITH_PARAMS = TfheParams(
    name="arith_m2c2_v32",
    n=620,
    k=1,
    N=2048,
    pbs_base_log=7,
    pbs_level=3,
    ks_base_log=2,
    ks_level=8,
    lwe_noise_std=64.0,
    glwe_noise_std=4.0,
    msg_space_log=5,  # 2 msg + 2 carry + padding
    message_bits=2,
)

# ----------------------------------------------------------------------
# Fast test sets (tiny, noise-free -> exact pipeline validation)
# ----------------------------------------------------------------------

TEST_PARAMS = TfheParams(
    name="test_tiny",
    n=16,
    k=1,
    N=64,
    pbs_base_log=8,
    pbs_level=2,
    ks_base_log=4,
    ks_level=4,
    lwe_noise_std=0.0,
    glwe_noise_std=0.0,
    msg_space_log=3,
    message_bits=1,
)

TEST_PARAMS_LUT = TfheParams(
    name="test_tiny_lut",
    n=16,
    k=1,
    N=128,
    pbs_base_log=8,
    pbs_level=2,
    ks_base_log=4,
    ks_level=4,
    lwe_noise_std=0.0,
    glwe_noise_std=0.0,
    msg_space_log=4,
    message_bits=3,
)

TEST_PARAMS_ARITH = TfheParams(
    name="test_tiny_arith",
    n=16,
    k=1,
    N=256,
    pbs_base_log=8,
    pbs_level=2,
    ks_base_log=4,
    ks_level=4,
    lwe_noise_std=0.0,
    glwe_noise_std=0.0,
    msg_space_log=5,
    message_bits=2,
)

TEST_PARAMS_LUT_MB = TfheParams(
    name="test_tiny_lut_mb2",
    n=16,
    k=1,
    N=128,
    pbs_base_log=8,
    pbs_level=2,
    ks_base_log=4,
    ks_level=4,
    lwe_noise_std=0.0,
    glwe_noise_std=0.0,
    msg_space_log=4,
    message_bits=3,
    grouping=2,
)

TEST_PARAMS_ARITH_MB = TfheParams(
    name="test_tiny_arith_mb2",
    n=16,
    k=1,
    N=256,
    pbs_base_log=8,
    pbs_level=2,
    ks_base_log=4,
    ks_level=4,
    lwe_noise_std=0.0,
    glwe_noise_std=0.0,
    msg_space_log=5,
    message_bits=2,
    grouping=2,
)

#: Small-but-noisy set for statistical noise tests.
TEST_PARAMS_NOISY = TfheParams(
    name="test_tiny_noisy",
    n=64,
    k=1,
    N=256,
    pbs_base_log=6,
    pbs_level=3,
    ks_base_log=2,
    ks_level=7,
    lwe_noise_std=4.0,
    glwe_noise_std=4.0,
    msg_space_log=3,
    message_bits=1,
)

#: Noisy multibit gates set for the DEFAULT test suite: real sigma>0
#: decryption margins through the production (grouping-2) code path at
#: test-scale dimensions. Failure 2^-138 at XOR growth — never flakes.
TEST_NOISY_GATES_MB = TfheParams(
    name="test_noisy_gates_mb",
    n=64,
    k=1,
    N=256,
    pbs_base_log=6,
    pbs_level=3,
    ks_base_log=2,
    ks_level=7,
    lwe_noise_std=4.0,
    glwe_noise_std=4.0,
    msg_space_log=3,
    message_bits=1,
    grouping=2,
)

#: Noisy LUT-mode set (3-bit messages, grouping 2). Failure 2^-61 at the
#: 3-input packing growth 21.
TEST_NOISY_LUT = TfheParams(
    name="test_noisy_lut",
    n=32,
    k=1,
    N=256,
    pbs_base_log=8,
    pbs_level=2,
    ks_base_log=2,
    ks_level=7,
    lwe_noise_std=4.0,
    glwe_noise_std=2.0,
    msg_space_log=4,
    message_bits=3,
    grouping=2,
)

#: Noisy k=2 LUT set: the LUT_128_K2 geometry (k=2/N=1024 GLWE, B=2
#: keyswitch) scaled down for CPU-speed CI, real noise. Exercises the
#: k=2 multibit kernel + long-B=2-ladder keyswitch paths end to end.
TEST_NOISY_LUT_K2 = TfheParams(
    name="test_noisy_lut_k2",
    n=32,
    k=2,
    N=128,
    pbs_base_log=8,
    pbs_level=2,
    ks_base_log=1,
    ks_level=14,
    lwe_noise_std=4.0,
    glwe_noise_std=2.0,
    msg_space_log=4,
    message_bits=3,
    grouping=2,
)

#: Noisy arith-mode set (2-bit blocks + carry, grouping 2). Failure 2^-35
#: at the mux-bivariate growth 18.
TEST_NOISY_ARITH = TfheParams(
    name="test_noisy_arith",
    n=32,
    k=1,
    N=512,
    pbs_base_log=8,
    pbs_level=2,
    ks_base_log=2,
    ks_level=7,
    lwe_noise_std=4.0,
    glwe_noise_std=2.0,
    msg_space_log=5,
    message_bits=2,
    grouping=2,
)

#: TPU-tuned gates set: level 2 with a wider base cuts the per-iteration
#: transform count from 8 to 6 at the same failure rate (needs the quieter
#: BSK sigma=8; ~29-bit modulus-to-noise gap at N=1024 — see SECURITY.md).
GATES_TPU = TfheParams(
    name="gates_tpu_v32",
    n=512,
    k=1,
    N=1024,
    pbs_base_log=11,
    pbs_level=2,
    ks_base_log=2,
    ks_level=8,
    lwe_noise_std=128.0,
    glwe_noise_std=8.0,
    msg_space_log=3,
    message_bits=1,
)

#: Multi-bit gates set: 2x fewer blind-rotation steps; per-step noise grows
#: ~3x in std which the gates margin absorbs (see pbs_failure_log2 test).
GATES_MB2 = TfheParams(
    name="gates_mb2_v32",
    n=512,
    k=1,
    N=1024,
    pbs_base_log=7,
    pbs_level=3,
    ks_base_log=2,
    ks_level=8,
    lwe_noise_std=128.0,
    glwe_noise_std=128.0,
    msg_space_log=3,
    message_bits=1,
    grouping=2,
)

#: TPU-tuned multi-bit gates set: GATES_TPU with grouping 2. Halves the
#: blind-rotation steps; the grouped external product multiplies the BSK
#: noise variance by ~||P_v||^2 ~ 9 over n/2 steps (net ~4.5x), which the
#: quiet sigma=8 BSK absorbs: per-PBS failure ~2^-30.6 at XOR linear growth
#: (vs 2^-95.8 single-bit) — ample for circuit evaluation.
GATES_TPU_MB2 = TfheParams(
    name="gates_tpu_mb2",
    n=512,
    k=1,
    N=1024,
    pbs_base_log=11,
    pbs_level=2,
    ks_base_log=2,
    ks_level=8,
    lwe_noise_std=128.0,
    glwe_noise_std=8.0,
    msg_space_log=3,
    message_bits=1,
    grouping=2,
)

#: Grouping-4 gates set: n/4 = 128 blind-rotation steps (2x fewer than MB2,
#: 4x fewer than single-bit) — the latency set for narrow circuits, where
#: per-level time is step-count-bound. The (3^g-1)/(2g) = 10x grouped noise
#: multiplier needs the narrower base 2^10 (still level 2): per-PBS failure
#: ~2^-49 at XOR linear growth under the grouping-aware model above.
GATES_TPU_MB4 = TfheParams(
    name="gates_tpu_mb4",
    n=512,
    k=1,
    N=1024,
    pbs_base_log=10,
    pbs_level=2,
    ks_base_log=2,
    ks_level=8,
    lwe_noise_std=128.0,
    glwe_noise_std=8.0,
    msg_space_log=3,
    message_bits=1,
    grouping=4,
)

#: Multi-bit arithmetic set: ARITH_PARAMS with grouping 2 (the reference's
#: arith mode is also multi-bit — PARAM_MULTI_BIT_MESSAGE_2_CARRY_2_GROUP_3,
#: src/bin/helm.rs:81-88). Halves the blind-rotation steps (620 -> 310) and
#: rides the frequency-in-sublanes MXU kernel; the (3^g-1)/(2g) = 2x grouped
#: noise multiplier keeps per-PBS failure at 2^-49.3 with linear growth 17
#: (bivariate 4x+y packing) — same margin as the single-bit set (2^-49.9).
ARITH_TPU_MB2 = TfheParams(
    name="arith_tpu_mb2",
    n=620,
    k=1,
    N=2048,
    pbs_base_log=7,
    pbs_level=3,
    ks_base_log=2,
    ks_level=8,
    lwe_noise_std=64.0,
    glwe_noise_std=4.0,
    msg_space_log=5,
    message_bits=2,
    grouping=2,
)

#: Multi-bit LUT set: LUT_PARAMS with grouping 2 and a wider/shallower
#: gadget (base 2^9, level 2): 4 decomposition rows instead of 6 AND half
#: the steps (700 -> 350). Per-PBS failure 2^-50.6 at linear growth 17.
LUT_TPU_MB2 = TfheParams(
    name="lut_tpu_mb2",
    n=700,
    k=1,
    N=2048,
    pbs_base_log=9,
    pbs_level=2,
    ks_base_log=2,
    ks_level=8,
    lwe_noise_std=64.0,
    glwe_noise_std=4.0,
    msg_space_log=4,
    message_bits=3,
    grouping=2,
)

#: 128-bit-class gates set (see fhe/security.py and SECURITY.md). The
#: reference-mirroring sets above inherit the reference GPU engine's weak
#: n=512/sigma=128 LWE key (~35-bit core-SVP; reference:
#: src/bin/helm.rs:141-146 uses one sigma for both keys); this family
#: instead anchors the LWE key on tfhe-rs 0.4's 128-bit boolean ratio
#: (n=742, sigma/q = 7.07e-6 -> ~104-bit core-SVP = the same margin the
#: lattice-estimator default scores ~128) and oversizes the GLWE ring
#: (N=2048, sigma=4: ~197-bit core-SVP). Cost vs GATES_TPU_MB2: 1.45x
#: steps and ~2x transform width. Failure 2^-43.8 at XOR growth 8 under
#: the measurement-corrected noise model (B=2/l=16 keyswitch; see
#: SECURITY.md noise validation 2026-08-20).
GATES_128_MB2 = TfheParams(
    name="gates_128_mb2",
    n=742,
    k=1,
    N=2048,
    pbs_base_log=11,
    pbs_level=2,
    ks_base_log=1,
    ks_level=16,
    lwe_noise_std=30355.0,
    glwe_noise_std=4.0,
    msg_space_log=3,
    message_bits=1,
    grouping=2,
)

#: 128-bit-class gates set, k=3/N=512 GLWE (the tfhe-rs 0.4 boolean
#: DEFAULT_PARAMETERS shape — reference L0 via Cargo.toml:18 — re-tuned for
#: this kernel with tools/param_search.py under the in-repo core-SVP
#: estimator and noise model). Same 1536-dim GLWE security as k=1/N=2048
#: at 1/4 the transform area per external-product row; the fs kernel's
#: per-step cost model scores it 1.84x cheaper than GATES_128_MB2.
#: Security: LWE n=704/sigma=2^16 -> 104.8-bit core-SVP (the same margin
#: the maintained lattice-estimator default scores ~128 for tfhe-rs's
#: n=742 key); GLWE kN=1536/sigma=4 -> 135.5-bit. Failure 2^-37.3 at XOR
#: growth 8 under the measurement-corrected model (modswitch-dominated:
#: N=512 rounds the mask to 2N=1024; B=2/l=14 keyswitch keeps the KS term
#: small — see SECURITY.md noise validation 2026-08-20).
GATES_128_K3 = TfheParams(
    name="gates_128_k3",
    n=704,
    k=3,
    N=512,
    pbs_base_log=9,
    pbs_level=2,
    ks_base_log=1,
    ks_level=14,
    lwe_noise_std=65536.0,
    glwe_noise_std=4.0,
    msg_space_log=3,
    message_bits=1,
    grouping=2,
)

#: 128-bit-class LUT set (3-bit messages). Failure 2^-31.2 at the 3-input
#: pack growth 21 under the measurement-corrected model (B=2/l=16
#: keyswitch).
LUT_128_MB2 = TfheParams(
    name="lut_128_mb2",
    n=742,
    k=1,
    N=2048,
    pbs_base_log=8,
    pbs_level=3,
    ks_base_log=1,
    ks_level=16,
    lwe_noise_std=30355.0,
    glwe_noise_std=4.0,
    msg_space_log=4,
    message_bits=3,
    grouping=2,
)

#: 128-bit-class arith set. msg_space 5 leaves only a 2^26 margin at
#: q=2^32, so the LWE key moves to n=832/sigma=2^13 (106-bit core-SVP)
#: to keep the keyswitch quiet, with KS B=2/l=17. Failure 2^-30.5 at
#: growth 18 under the measurement-corrected model; the modswitch term
#: dominates (the q=2^32 squeeze — see SECURITY.md).
ARITH_128_MB2 = TfheParams(
    name="arith_128_mb2",
    n=832,
    k=1,
    N=2048,
    pbs_base_log=7,
    pbs_level=3,
    ks_base_log=1,
    ks_level=17,
    lwe_noise_std=8192.0,
    glwe_noise_std=4.0,
    msg_space_log=5,
    message_bits=2,
    grouping=2,
)

#: 128-bit-class LUT set, k=2/N=1024 GLWE — the gates_128_k3 trick applied
#: to LUT mode (tools/param_search.py msg_space-4 variant under the
#: measurement-corrected noise model + measured round-3 kernel cost split):
#: same 2048-dim GLWE security as k=1/N=2048 at half the per-row transform
#: area, and it dodges the measured ~1.35x N=2048 VMEM penalty — modeled
#: 0.75x the cost of LUT_128_MB2. Security: LWE n=770/sigma=19639 ->
#: 104.2-bit core-SVP; GLWE kN=2048/sigma=4 -> 197-bit. Failure 2^-32.6 at
#: the 3-input pack growth 21 (better margin than LUT_128_MB2's 2^-31.2).
LUT_128_K2 = TfheParams(
    name="lut_128_k2",
    n=770,
    k=2,
    N=1024,
    pbs_base_log=7,
    pbs_level=3,
    ks_base_log=1,
    ks_level=16,
    lwe_noise_std=19639.0,
    glwe_noise_std=4.0,
    msg_space_log=4,
    message_bits=3,
    grouping=2,
)

TEST_PARAMS_MB = TfheParams(
    name="test_tiny_mb2",
    n=16,
    k=1,
    N=64,
    pbs_base_log=8,
    pbs_level=2,
    ks_base_log=4,
    ks_level=4,
    lwe_noise_std=0.0,
    glwe_noise_std=0.0,
    msg_space_log=3,
    message_bits=1,
    grouping=2,
)

#: Tiny k=3 set: exercises the GLWE-dimension-general (k > 1) paths that
#: GATES_128_K3 rides in production.
TEST_PARAMS_K3 = TfheParams(
    name="test_tiny_k3",
    n=16,
    k=3,
    N=64,
    pbs_base_log=8,
    pbs_level=2,
    ks_base_log=4,
    ks_level=4,
    lwe_noise_std=0.0,
    glwe_noise_std=0.0,
    msg_space_log=3,
    message_bits=1,
    grouping=2,
)

TEST_PARAMS_MB4 = TfheParams(
    name="test_tiny_mb4",
    n=16,
    k=1,
    N=64,
    pbs_base_log=8,
    pbs_level=2,
    ks_base_log=4,
    ks_level=4,
    lwe_noise_std=0.0,
    glwe_noise_std=0.0,
    msg_space_log=3,
    message_bits=1,
    grouping=4,
)

# ----------------------------------------------------------------------
# Deployment defaults + weak-set warning
# ----------------------------------------------------------------------

#: Engine/CLI defaults: the ≥100-bit-core-SVP deployment family — the same
#: security class as the reference's flagship CPU path (tfhe-rs boolean
#: defaults, reference src/bin/helm.rs:241). The reference-GPU-mirroring
#: sets (GATES_PARAMS et al., ~35–55-bit core-SVP) stay selectable via
#: --params but print a warning naming their security level.
DEFAULT_GATES = GATES_128_K3
DEFAULT_LUT = LUT_128_K2
DEFAULT_ARITH = ARITH_128_MB2

_warned_weak: set[str] = set()


def warn_if_weak(p: TfheParams) -> None:
    """Print a loud once-per-set warning when a sub-100-bit production set
    is selected (SECURITY.md: the reference-GPU-mirroring family's LWE key
    is ~35-bit core-SVP). Noise-free `test_*` fixtures are exempt — they
    are deliberately insecure pipeline-validation sets, not deployment
    candidates."""
    import sys

    if p.name.startswith("test") or p.name in _warned_weak:
        return
    from .fhe.security import security_bits

    bits = security_bits(p)
    if bits < 100.0:
        _warned_weak.add(p.name)
        print(
            f"[helm_tpu_torch] WARNING: parameter set '{p.name}' is ~{bits:.0f}-bit"
            " core-SVP — NOT a deployment-grade security level. Use the"
            " default 128-bit family (gates_128_k3 / lut_128_k2 /"
            " arith_128_mb2) for anything but A/B benchmarking"
            " (see SECURITY.md).",
            file=sys.stderr,
        )


def from_reference(p) -> TfheParams:
    """The port's TfheParams for a `helm_tpu.params.TfheParams`, field by
    field (duck-typed: nothing of helm_tpu is imported). A set whose name
    is in ALL_PARAMS must equal the port's set of that name, and that set
    is returned."""
    got = TfheParams(**{f.name: getattr(p, f.name) for f in fields(TfheParams)})
    mine = ALL_PARAMS.get(got.name)
    if mine is None:
        return got
    if mine != got:
        raise ValueError(
            f"parameter set {got.name!r} differs between helm_tpu and "
            f"helm_tpu_torch: {got} vs {mine}"
        )
    return mine


ALL_PARAMS = {
    p.name: p
    for p in (
        GATES_PARAMS,
        LUT_PARAMS,
        ARITH_PARAMS,
        TEST_PARAMS,
        TEST_PARAMS_LUT,
        TEST_PARAMS_ARITH,
        TEST_PARAMS_NOISY,
        TEST_NOISY_GATES_MB,
        TEST_NOISY_LUT,
        TEST_NOISY_LUT_K2,
        TEST_NOISY_ARITH,
        GATES_TPU,
        GATES_MB2,
        GATES_TPU_MB2,
        GATES_TPU_MB4,
        ARITH_TPU_MB2,
        LUT_TPU_MB2,
        GATES_128_MB2,
        GATES_128_K3,
        LUT_128_MB2,
        LUT_128_K2,
        ARITH_128_MB2,
        TEST_PARAMS_MB,
        TEST_PARAMS_K3,
    )
}
