"""KZG commitment parameters + the CQ TableSRS.

Mirrors reference poly/kzg/commitment.rs:
  - ParamsKZG { g, g_lagrange, g2, s_g2 }  (commitment.rs:31-39)
  - TableSRS  { g1, g1_lagrange, g_lagrange_opening_at_0, g2 } (42-47)
  - setup_from_toxic_waste for both (73-178, 209-276), building the Lagrange
    basis directly from the known s via
        L_i(s) = (s^N - 1)/N * omega^i / (s - omega^i)          (134-142)
    and the opening-at-0 basis via
        [(L_i(x)-L_i(0))/x]_1 = omega^{-i}[L_i(x)]_1 - (1/N)[x^{N-1}]_1
                                                                 (156-170)

commit/commit_lagrange dispatch through ops/msm.py: host Pippenger for tiny
commitments, device Pippenger for bulk ones.  Production-grade SRS generation at
2^20+ runs the power chains on device (vectorized double-and-add).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence

from ...curves import host as CH
from ...fields import host as H
from ...ops import msm as M

P = H.FR_MOD


def _omega_for_k(k: int) -> int:
    w = H.FR_ROOT_OF_UNITY
    for _ in range(k, H.FR_S):
        w = w * w % P
    return w


def _g1_gen_muls(scalars: List[int]) -> List[CH.G1Affine]:
    """[k * G1_GEN for k in scalars] via the native OpenMP batch kernel."""
    from ...native_loader import native_batch_scalar_mul
    jac = [CH.jac_from_affine(CH.G1_GEN)] * len(scalars)
    res = native_batch_scalar_mul(jac, scalars)
    if res is None:
        return [CH.g1_mul(CH.G1_GEN, k) for k in scalars]
    return CH.jac_batch_to_affine(res)


def _g1_powers_of_s(s: int, n: int) -> List[CH.G1Affine]:
    pows = [1] * n
    for i in range(1, n):
        pows[i] = pows[i - 1] * s % P
    return _g1_gen_muls(pows)


def _lagrange_basis_from_s(s: int, n: int) -> List[CH.G1Affine]:
    k = n.bit_length() - 1
    omega = _omega_for_k(k)
    n_inv = pow(n, P - 2, P)
    multiplier = (pow(s, n, P) - 1) * n_inv % P
    denoms = [(s - pow(omega, i, P)) % P for i in range(n)]
    denom_invs = H.batch_inv(denoms, P)
    return _g1_gen_muls([
        multiplier * pow(omega, i, P) % P * denom_invs[i] % P for i in range(n)
    ])


@dataclass
class ParamsKZG:
    """Prover/verifier parameters for the circuit-side KZG commitments."""
    k: int
    n: int
    g: List[CH.G1Affine]             # monomial basis [s^i]_1
    g_lagrange: List[CH.G1Affine]    # Lagrange basis [L_i(s)]_1
    g2: CH.G2Affine                  # [1]_2
    s_g2: CH.G2Affine                # [s]_2

    @staticmethod
    def setup_from_toxic_waste(k: int, s: int) -> "ParamsKZG":
        assert k <= H.FR_S
        n = 1 << k
        s %= P
        return ParamsKZG(
            k=k,
            n=n,
            g=_g1_powers_of_s(s, n),
            g_lagrange=_lagrange_basis_from_s(s, n),
            g2=CH.G2_GEN,
            s_g2=CH.g2_mul(CH.G2_GEN, s),
        )

    def commit(self, coeffs: Sequence[int]) -> CH.G1Affine:
        """Commit to a polynomial in coefficient (monomial) form."""
        assert len(coeffs) <= len(self.g)
        return M.msm(list(coeffs), self.g[: len(coeffs)],
                     packed=M.packed_basis(self, "_g_packed", self.g))

    def commit_lagrange(self, values: Sequence[int]) -> CH.G1Affine:
        """Commit to a polynomial given by its evaluations on the domain."""
        assert len(values) == self.n
        return M.msm(list(values), self.g_lagrange,
                     packed=M.packed_basis(self, "_g_lagrange_packed",
                                           self.g_lagrange))

    def commit_coeff_buf(self, buf) -> CH.G1Affine:
        """commit() for a (m, 4) canonical u64 coeff buffer — no bigint
        round trip (the GWC witness commitments)."""
        assert buf.shape[0] <= len(self.g)
        packed = M.packed_basis(self, "_g_packed", self.g)
        return M.msm_multi([(packed, None, buf, self.g)])[0]

    def commit_lagrange_many(self, columns) -> list:
        """Batch commit_lagrange over many value lists: one native
        g1_msm_multi call, OpenMP across columns (the prover's per-phase
        advice commitment batch)."""
        packed = M.packed_basis(self, "_g_lagrange_packed", self.g_lagrange)
        return M.msm_multi([(packed, None, col, self.g_lagrange)
                            for col in columns])

    def verifier_params(self) -> "ParamsKZG":
        return self


@dataclass
class TableSRS:
    """SRS for CQ static tables: includes long G2 power list and the
    Lagrange-opening-at-0 basis (reference commitment.rs:42-47).

    g1_xn ([x^N]_1, one power past the Lagrange range) exists only to blind
    CQ commitments with multiples of [Z_V]_1 = [x^N]_1 - [1]_1 in the zk
    static-lookup mode (plonk/static_lookup.py); the reference's SRS stops
    at x^{N-1} because its CQ argument is explicitly non-zk
    (static_lookup/prover.rs:122-124)."""
    g1: List[CH.G1Affine]
    g1_lagrange: List[CH.G1Affine]
    g_lagrange_opening_at_0: List[CH.G1Affine]
    g2: List[CH.G2Affine]
    g1_xn: CH.G1Affine = None

    @staticmethod
    def setup_from_toxic_waste(max_g1_power: int, max_g2_power: int, s: int) -> "TableSRS":
        g1_len = max_g1_power + 1
        g2_len = max_g2_power + 1
        assert g1_len & (g1_len - 1) == 0, "g1_len must be a power of two"
        s %= P
        n = g1_len
        k = n.bit_length() - 1
        omega = _omega_for_k(k)
        n_inv = pow(n, P - 2, P)

        from ...native_loader import native_batch_scalar_mul, native_g2_batch_scalar_mul

        g1 = _g1_powers_of_s(s, g1_len)
        s_pows = [1] * g2_len
        for i in range(1, g2_len):
            s_pows[i] = s_pows[i - 1] * s % P
        g2 = native_g2_batch_scalar_mul([CH.G2_GEN] * g2_len, s_pows)
        if g2 is None:
            g2 = [CH.g2_mul(CH.G2_GEN, c) for c in s_pows]

        g1_lagrange = _lagrange_basis_from_s(s, n)

        # [(L_i(x) - L_i(0))/x]_1 = omega^{-i} [L_i(x)]_1 - (1/N) [x^{N-1}]_1
        omega_inv = pow(omega, P - 2, P)
        last_scaled = CH.g1_mul(g1[-1], n_inv)
        neg_last = CH.g1_neg(last_scaled)
        w_pows = [1] * n
        for i in range(1, n):
            w_pows[i] = w_pows[i - 1] * omega_inv % P
        scaled = native_batch_scalar_mul(
            [CH.jac_from_affine(p) for p in g1_lagrange], w_pows)
        if scaled is None:
            scaled_aff = [CH.g1_mul(g1_lagrange[i], w_pows[i]) for i in range(n)]
        else:
            scaled_aff = CH.jac_batch_to_affine(scaled)
        opening_at_0 = [CH.g1_add(pt, neg_last) for pt in scaled_aff]
        g1_xn = CH.g1_mul(CH.G1_GEN, pow(s, g1_len, P))
        return TableSRS(g1, g1_lagrange, opening_at_0, g2, g1_xn)
