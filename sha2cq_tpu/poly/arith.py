"""Host polynomial arithmetic helpers (reference halo2_proofs/src/arithmetic.rs).

These are O(n) or O(n log n) scalar-side helpers that sit off the device hot
path (the bulk NTT/MSM work lives in ops/); kept as int-list functions so the
protocol layers can run/verify with no device round-trips for small circuits.

  - eval_polynomial    (arithmetic.rs:304-329, Horner)
  - kate_division      (arithmetic.rs:351-387) — quotient by (X - b); the
    reference carries an always-on O(n) re-multiplication sanity check, we
    gate it behind `debug`
  - lagrange_interpolate (arithmetic.rs:425-478)
  - powers             (arithmetic.rs:500-507)
"""
from __future__ import annotations

from typing import Iterable, Iterator, List, Sequence

from ..fields.host import FR_MOD, batch_inv, inv_mod

P = FR_MOD


def as_coeff_list(poly) -> List[int]:
    """Coefficient polys travel as int lists OR canonical (n, 4) u64 limb
    buffers (the device/native prover keeps them resident as buffers to skip
    per-boundary bigint conversion); this is the list view of either."""
    import numpy as np
    if isinstance(poly, np.ndarray):
        from ..native_loader import fr_unbuf
        return fr_unbuf(poly)
    return poly


def eval_polynomial(coeffs, x: int) -> int:
    import numpy as np
    if isinstance(coeffs, np.ndarray):
        from ..native_loader import native_fr_eval_buf
        out = native_fr_eval_buf(np.ascontiguousarray(coeffs), x % P)
        if out is not None:
            return out
        coeffs = as_coeff_list(coeffs)
    if len(coeffs) >= 512:
        from ..native_loader import native_fr_eval
        out = native_fr_eval([c % P for c in coeffs], x % P)
        if out is not None:
            return out
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * x + c) % P
    return acc


def kate_division(coeffs: Sequence[int], b: int, debug: bool = False) -> List[int]:
    """q(X) = (p(X) - p(b)) / (X - b); len(q) = len(p) - 1... we return
    len(p) coefficients with trailing zero to match the reference's shape."""
    n = len(coeffs)
    if n >= 512 and not debug:
        from ..native_loader import fr_buf, fr_unbuf, native_fr_kate_buf
        qbuf = native_fr_kate_buf(fr_buf([c % P for c in coeffs]), b % P)
        if qbuf is not None:
            return fr_unbuf(qbuf) + [0]
    q = [0] * n
    tmp = 0
    # synthetic division from the top
    for i in range(n - 1, -1, -1):
        q[i] = tmp = (coeffs[i] + tmp * b) % P
    # q[0] holds p(b); shift: quotient coeffs are q[1..]
    out = q[1:] + [0]
    if debug:
        # re-multiply: out * (X - b) + p(b) == p
        pb = eval_polynomial(coeffs, b)
        recon = [0] * n
        for i, c in enumerate(out):
            recon[i] = (recon[i] - c * b) % P
            if i + 1 < n:
                recon[i + 1] = (recon[i + 1] + c) % P
        recon[0] = (recon[0] + pb) % P
        assert recon == [c % P for c in coeffs], "kate_division sanity failed"
    return out


def lagrange_interpolate(points: Sequence[int], evals: Sequence[int]) -> List[int]:
    assert len(points) == len(evals)
    n = len(points)
    if n == 1:
        return [evals[0] % P]
    denoms = []
    for j, xj in enumerate(points):
        d = 1
        for k, xk in enumerate(points):
            if k != j:
                d = d * (xj - xk) % P
        denoms.append(d)
    denom_invs = batch_inv(denoms, P)
    final = [0] * n
    for j, (xj, ej) in enumerate(zip(points, evals)):
        # basis poly prod_{k!=j} (X - x_k)
        basis = [1]
        for k, xk in enumerate(points):
            if k == j:
                continue
            new = [0] * (len(basis) + 1)
            for i, c in enumerate(basis):
                new[i] = (new[i] - c * xk) % P
                new[i + 1] = (new[i + 1] + c) % P
            basis = new
        scale = ej * denom_invs[j] % P
        for i, c in enumerate(basis):
            final[i] = (final[i] + c * scale) % P
    return final


def powers(base: int) -> Iterator[int]:
    """1, base, base^2, ... (infinite)."""
    cur = 1
    while True:
        yield cur
        cur = cur * base % P


def poly_add(a: Sequence[int], b: Sequence[int]) -> List[int]:
    n = max(len(a), len(b))
    return [((a[i] if i < len(a) else 0) + (b[i] if i < len(b) else 0)) % P for i in range(n)]


def poly_scale(a: Sequence[int], s: int) -> List[int]:
    return [c * s % P for c in a]
