"""Host-side BN254 group layer: G1, G2, optimal-ate pairing, PairingBatcher.

Capability parity with the reference:
  - G1/G2 affine+Jacobian point arithmetic  (arithmetic/curves/src/bn256/curve.rs,
    derive/curve.rs new_curve_impl!)
  - optimal-ate pairing: multi_miller_loop + final_exponentiation
    (bn256/engine.rs:206-660)
  - PairingBatcher: dedups G2 points and random-linear-combines G1 sides so a
    whole verification reduces to one multi-Miller loop
    (arithmetic/curves/src/batch_pairing.rs:7-95)

This module is the verifier-side oracle.  Group arithmetic the *prover* needs
in bulk (MSM over G1) runs in `ops/msm.py` (native Pippenger, or the device
window-sum kernel); single-point host ops
here use Python ints (no Montgomery form).
"""
from __future__ import annotations

from typing import Iterable, List, Optional, Sequence, Tuple

from ..fields import host as F
from ..fields.host import (
    FQ_MOD, FR_MOD, FQ2_ONE, FQ2_ZERO, FQ12_ONE,
    fq2_add, fq2_sub, fq2_mul, fq2_sq, fq2_neg, fq2_inv, fq2_conj, fq2_scalar,
    fq12_mul, fq12_sq, fq12_inv, fq12_conj, fq12_frob, fq12_pow,
    fq6_neg, inv_mod,
)

P = FQ_MOD

# G1: y^2 = x^3 + 3 over Fq; generator (1, 2)
G1_B = 3
G1_GEN = (1, 2)

# G2: y^2 = x^3 + 3/(9+u) over Fq2 (D-type twist); canonical generator
G2_B = fq2_mul((3, 0), fq2_inv((9, 1)))
G2_GEN = (
    (
        10857046999023057135944570762232829481370756359578518086990519993285655852781,
        11559732032986387107991004021392285783925812861821192530917403151452391805634,
    ),
    (
        8495653923123431417604973247489272438418190587263600148770280649306958101930,
        4082367875863433681332203403145435568316851327593401208105741076214120093531,
    ),
)

# Affine points are (x, y) tuples; the identity is None.
G1Affine = Optional[Tuple[int, int]]
G2Affine = Optional[Tuple[Tuple[int, int], Tuple[int, int]]]


# ------------------------------- G1 ----------------------------------------
# Hot host paths (SRS generation, FK preprocessing, small MSMs) run in
# Jacobian coordinates — a field inversion costs ~50 multiplies, so affine
# chains would be inversion-bound.  Jacobian point = (X, Y, Z) ints, Z=0 is
# the identity.

JAC_IDENTITY = (1, 1, 0)


def jac_from_affine(pt: G1Affine):
    return JAC_IDENTITY if pt is None else (pt[0], pt[1], 1)


def jac_double(p):
    X1, Y1, Z1 = p
    if Z1 == 0 or Y1 == 0:
        return JAC_IDENTITY if Z1 == 0 else JAC_IDENTITY
    A = X1 * X1 % P
    B = Y1 * Y1 % P
    C = B * B % P
    D = 2 * ((X1 + B) * (X1 + B) - A - C) % P
    E = 3 * A % P
    F = E * E % P
    X3 = (F - 2 * D) % P
    Y3 = (E * (D - X3) - 8 * C) % P
    Z3 = 2 * Y1 * Z1 % P
    return (X3, Y3, Z3)


def jac_add(p, q):
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    if Z1 == 0:
        return q
    if Z2 == 0:
        return p
    Z1Z1 = Z1 * Z1 % P
    Z2Z2 = Z2 * Z2 % P
    U1 = X1 * Z2Z2 % P
    U2 = X2 * Z1Z1 % P
    S1 = Y1 * Z2 * Z2Z2 % P
    S2 = Y2 * Z1 * Z1Z1 % P
    if U1 == U2:
        if (S1 + S2) % P == 0:
            return JAC_IDENTITY
        return jac_double(p)
    H = (U2 - U1) % P
    HH = H * H % P
    HHH = H * HH % P
    V = U1 * HH % P
    r = (S2 - S1) % P
    X3 = (r * r - HHH - 2 * V) % P
    Y3 = (r * (V - X3) - S1 * HHH) % P
    Z3 = Z1 * Z2 % P * H % P
    return (X3, Y3, Z3)


def jac_add_affine(p, a: G1Affine):
    """Mixed addition p (Jacobian) + a (affine)."""
    if a is None:
        return p
    X1, Y1, Z1 = p
    if Z1 == 0:
        return (a[0], a[1], 1)
    X2, Y2 = a
    Z1Z1 = Z1 * Z1 % P
    U2 = X2 * Z1Z1 % P
    S2 = Y2 * Z1 * Z1Z1 % P
    if U2 == X1:
        if (Y1 + S2) % P == 0:
            return JAC_IDENTITY
        return jac_double(p)
    H = (U2 - X1) % P
    HH = H * H % P
    HHH = H * HH % P
    V = X1 * HH % P
    r = (S2 - Y1) % P
    X3 = (r * r - HHH - 2 * V) % P
    Y3 = (r * (V - X3) - Y1 * HHH) % P
    Z3 = Z1 * H % P
    return (X3, Y3, Z3)


def jac_mul(p, k: int):
    k %= FR_MOD
    if k == 0 or p[2] == 0:
        return JAC_IDENTITY
    native = _native_jac_mul(p, k)
    if native is not None:
        return native
    result = JAC_IDENTITY
    add = p
    while k:
        if k & 1:
            result = jac_add(result, add)
        add = jac_double(add)
        k >>= 1
    return result


def _native_jac_mul(p, k):
    try:
        from ..native_loader import native_jac_mul
    except ImportError:
        return None
    return native_jac_mul(p, k)


def jac_to_affine(p) -> G1Affine:
    X, Y, Z = p
    if Z == 0:
        return None
    from ..native_loader import native_jac_to_affine
    out = native_jac_to_affine(p)
    if out is not None:
        return None if out == (None,) else out
    zi = inv_mod(Z, P)
    zi2 = zi * zi % P
    return (X * zi2 % P, Y * zi2 % P * zi % P)


def jac_batch_to_affine(points) -> list:
    """Normalize many Jacobian points with one shared inversion chain."""
    from ..fields.host import batch_inv
    zs = [p[2] for p in points]
    zinvs = batch_inv(zs, P)
    out = []
    for (X, Y, Z), zi in zip(points, zinvs):
        if Z == 0:
            out.append(None)
        else:
            zi2 = zi * zi % P
            out.append((X * zi2 % P, Y * zi2 % P * zi % P))
    return out


def g1_is_on_curve(pt: G1Affine) -> bool:
    if pt is None:
        return True
    x, y = pt
    return (y * y - x * x * x - G1_B) % P == 0


def g1_neg(pt: G1Affine) -> G1Affine:
    if pt is None:
        return None
    return (pt[0], (-pt[1]) % P)


def g1_add(a: G1Affine, b: G1Affine) -> G1Affine:
    if a is None:
        return b
    if b is None:
        return a
    x1, y1 = a
    x2, y2 = b
    if x1 == x2:
        if (y1 + y2) % P == 0:
            return None
        # doubling
        lam = (3 * x1 * x1) * inv_mod(2 * y1, P) % P
    else:
        lam = (y2 - y1) * inv_mod(x2 - x1, P) % P
    x3 = (lam * lam - x1 - x2) % P
    y3 = (lam * (x1 - x3) - y1) % P
    return (x3, y3)


def g1_double(a: G1Affine) -> G1Affine:
    return g1_add(a, a)


def g1_mul(pt: G1Affine, k: int) -> G1Affine:
    return jac_to_affine(jac_mul(jac_from_affine(pt), k))


def g1_msm(scalars: Sequence[int], points: Sequence[G1Affine]) -> G1Affine:
    """Naive host MSM — oracle for the Pippenger kernels in ops/msm.py."""
    acc = JAC_IDENTITY
    for s, pt in zip(scalars, points):
        acc = jac_add(acc, jac_mul(jac_from_affine(pt), s))
    return jac_to_affine(acc)


# ------------------------------- G2 ----------------------------------------

def g2_is_on_curve(pt: G2Affine) -> bool:
    if pt is None:
        return True
    x, y = pt
    lhs = fq2_sq(y)
    rhs = fq2_add(fq2_mul(fq2_sq(x), x), G2_B)
    return lhs == rhs


def g2_neg(pt: G2Affine) -> G2Affine:
    if pt is None:
        return None
    return (pt[0], fq2_neg(pt[1]))


def g2_add(a: G2Affine, b: G2Affine) -> G2Affine:
    if a is None:
        return b
    if b is None:
        return a
    x1, y1 = a
    x2, y2 = b
    if x1 == x2:
        if fq2_add(y1, y2) == FQ2_ZERO:
            return None
        lam = fq2_mul(fq2_scalar(fq2_sq(x1), 3), fq2_inv(fq2_scalar(y1, 2)))
    else:
        lam = fq2_mul(fq2_sub(y2, y1), fq2_inv(fq2_sub(x2, x1)))
    x3 = fq2_sub(fq2_sub(fq2_sq(lam), x1), x2)
    y3 = fq2_sub(fq2_mul(lam, fq2_sub(x1, x3)), y1)
    return (x3, y3)


_G2_JAC_IDENTITY = (FQ2_ONE, FQ2_ONE, FQ2_ZERO)


def _g2_jac_double(p):
    X1, Y1, Z1 = p
    if Z1 == FQ2_ZERO:
        return _G2_JAC_IDENTITY
    A = fq2_sq(X1)
    B = fq2_sq(Y1)
    C = fq2_sq(B)
    t = fq2_sq(fq2_add(X1, B))
    D = fq2_scalar(fq2_sub(fq2_sub(t, A), C), 2)
    E = fq2_scalar(A, 3)
    F = fq2_sq(E)
    X3 = fq2_sub(F, fq2_scalar(D, 2))
    Y3 = fq2_sub(fq2_mul(E, fq2_sub(D, X3)), fq2_scalar(C, 8))
    Z3 = fq2_scalar(fq2_mul(Y1, Z1), 2)
    return (X3, Y3, Z3)


def _g2_jac_add(p, q):
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    if Z1 == FQ2_ZERO:
        return q
    if Z2 == FQ2_ZERO:
        return p
    Z1Z1 = fq2_sq(Z1)
    Z2Z2 = fq2_sq(Z2)
    U1 = fq2_mul(X1, Z2Z2)
    U2 = fq2_mul(X2, Z1Z1)
    S1 = fq2_mul(Y1, fq2_mul(Z2, Z2Z2))
    S2 = fq2_mul(Y2, fq2_mul(Z1, Z1Z1))
    if U1 == U2:
        if fq2_add(S1, S2) == FQ2_ZERO:
            return _G2_JAC_IDENTITY
        return _g2_jac_double(p)
    H = fq2_sub(U2, U1)
    HH = fq2_sq(H)
    HHH = fq2_mul(H, HH)
    V = fq2_mul(U1, HH)
    r = fq2_sub(S2, S1)
    X3 = fq2_sub(fq2_sub(fq2_sq(r), HHH), fq2_scalar(V, 2))
    Y3 = fq2_sub(fq2_mul(r, fq2_sub(V, X3)), fq2_mul(S1, HHH))
    Z3 = fq2_mul(fq2_mul(Z1, Z2), H)
    return (X3, Y3, Z3)


def _g2_jac_to_affine(p) -> G2Affine:
    X, Y, Z = p
    if Z == FQ2_ZERO:
        return None
    zi = fq2_inv(Z)
    zi2 = fq2_sq(zi)
    return (fq2_mul(X, zi2), fq2_mul(Y, fq2_mul(zi2, zi)))


def g2_mul(pt: G2Affine, k: int) -> G2Affine:
    if pt is None:
        return None
    k %= FR_MOD
    result = _G2_JAC_IDENTITY
    add = (pt[0], pt[1], FQ2_ONE)
    while k:
        if k & 1:
            result = _g2_jac_add(result, add)
        add = _g2_jac_double(add)
        k >>= 1
    return _g2_jac_to_affine(result)


# ----------------------------- pairing --------------------------------------
# Optimal ate pairing (reference bn256/engine.rs).  We untwist G2 into
# E(Fq12): psi(x, y) = (x * w^2, y * w^3) with w the Fq12 generator (w^2 = v,
# v^3 = xi), and run the Miller loop with line functions in Fq12.
# Correct and simple; the verifier only ever runs ONE multi-Miller loop per
# batch (PairingBatcher), so host speed here is acceptable.

# w^2 = v in Fq6 coords: (0, 1, 0); as Fq12: (v_elem, 0)
_W2 = ((FQ2_ZERO, FQ2_ONE, FQ2_ZERO), F.FQ6_ZERO)          # w^2
_W3 = (F.FQ6_ZERO, (FQ2_ZERO, FQ2_ONE, FQ2_ZERO))          # w^3 = v*w

Fq12Point = Optional[Tuple[tuple, tuple]]  # (x, y) in Fq12


def _fq2_to_fq12(a) -> tuple:
    return ((a, FQ2_ZERO, FQ2_ZERO), F.FQ6_ZERO)


def _fq_to_fq12(a: int) -> tuple:
    return (((a % P, 0), FQ2_ZERO, FQ2_ZERO), F.FQ6_ZERO)


def _untwist(q: G2Affine) -> Fq12Point:
    if q is None:
        return None
    x, y = q
    return (fq12_mul(_fq2_to_fq12(x), _W2), fq12_mul(_fq2_to_fq12(y), _W3))


def _fq12_point_neg(pt: Fq12Point) -> Fq12Point:
    if pt is None:
        return None
    return (pt[0], (fq6_neg(pt[1][0]), fq6_neg(pt[1][1])))


def _line(p1: Fq12Point, p2: Fq12Point, xt: tuple, yt: tuple) -> tuple:
    """Evaluate the line through p1, p2 (Fq12 points) at (xt, yt)."""
    x1, y1 = p1
    x2, y2 = p2
    if x1 != x2:
        lam = fq12_mul(F.fq12_sub(y2, y1), fq12_inv(F.fq12_sub(x2, x1)))
        return F.fq12_sub(fq12_mul(lam, F.fq12_sub(xt, x1)), F.fq12_sub(yt, y1))
    if y1 == y2:
        lam = fq12_mul(fq12_mul(_fq_to_fq12(3), fq12_sq(x1)), fq12_inv(fq12_mul(_fq_to_fq12(2), y1)))
        return F.fq12_sub(fq12_mul(lam, F.fq12_sub(xt, x1)), F.fq12_sub(yt, y1))
    return F.fq12_sub(xt, x1)


def _fq12_point_add(a: Fq12Point, b: Fq12Point) -> Fq12Point:
    if a is None:
        return b
    if b is None:
        return a
    x1, y1 = a
    x2, y2 = b
    if x1 == x2:
        if F.fq12_add(y1, y2) == F.FQ12_ZERO:
            return None
        lam = fq12_mul(fq12_mul(_fq_to_fq12(3), fq12_sq(x1)), fq12_inv(fq12_mul(_fq_to_fq12(2), y1)))
    else:
        lam = fq12_mul(F.fq12_sub(y2, y1), fq12_inv(F.fq12_sub(x2, x1)))
    x3 = F.fq12_sub(F.fq12_sub(fq12_sq(lam), x1), x2)
    y3 = F.fq12_sub(fq12_mul(lam, F.fq12_sub(x1, x3)), y1)
    return (x3, y3)


def _fq12_frob_point(pt: Fq12Point) -> Fq12Point:
    if pt is None:
        return None
    return (fq12_frob(pt[0], 1), fq12_frob(pt[1], 1))


def _miller_loop_fq12(p: G1Affine, q: G2Affine) -> tuple:
    """Affine untwist-to-Fq12 Miller loop — the original (slow, inversion-
    per-step) formulation, kept as the oracle for the fast path below."""
    if p is None or q is None:
        return FQ12_ONE
    qq = _untwist(q)
    xt = _fq_to_fq12(p[0])
    yt = _fq_to_fq12(p[1])
    t = qq
    f = FQ12_ONE
    for i in range(F.ATE_LOOP_COUNT.bit_length() - 2, -1, -1):
        f = fq12_mul(fq12_sq(f), _line(t, t, xt, yt))
        t = _fq12_point_add(t, t)
        if (F.ATE_LOOP_COUNT >> i) & 1:
            f = fq12_mul(f, _line(t, qq, xt, yt))
            t = _fq12_point_add(t, qq)
    # Frobenius corrections: Q1 = pi(Q), Q2 = -pi^2(Q)
    q1 = _fq12_frob_point(qq)
    nq2 = _fq12_point_neg(_fq12_frob_point(q1))
    f = fq12_mul(f, _line(t, q1, xt, yt))
    t = _fq12_point_add(t, q1)
    f = fq12_mul(f, _line(t, nq2, xt, yt))
    return f


# -- fast Miller loop: inversion-free Jacobian steps over Fq2 -----------------
#
# The untwisted point is (xt*w^2, yt*w^3) with xt, yt in Fq2, so all point
# arithmetic stays in Fq2; line functions come out supported on w-degrees
# {0, 1, 3} (derivation: L = lam*xp*w - lam*xt*w^3 - yp + yt*w^3 with
# lam = lam2*w), scaled by subfield constants that final exponentiation
# kills.  In the fq12 tower (g0 + g1*w over fq6 = a0 + a1*v + a2*v^2,
# w^2 = v) degrees {0, 1, 3} are components g0.a0, g1.a0, g1.a1.

def _sparse013(a0, a1, a3) -> tuple:
    return ((a0, FQ2_ZERO, FQ2_ZERO), (a1, a3, FQ2_ZERO))


def _dbl_step(t, xp: int, yp: int):
    """Jacobian double of t=(X,Y,Z) over Fq2 + line coeffs evaluated at P.
    Line (scaled by 2*yt*Zt^6): -2*Yt*Zt^3*yp @w0, 3*Xt^2*Zt^2*xp @w1,
    (2*Yt^2 - 3*Xt^3) @w3."""
    X, Y, Z = t
    XX = F.fq2_sq(X)
    YY = F.fq2_sq(Y)
    YYYY = F.fq2_sq(YY)
    ZZ = F.fq2_sq(Z)
    S = F.fq2_scalar(F.fq2_sub(F.fq2_sub(F.fq2_sq(F.fq2_add(X, YY)), XX), YYYY), 2)
    M = F.fq2_scalar(XX, 3)
    X3 = F.fq2_sub(F.fq2_sq(M), F.fq2_scalar(S, 2))
    Z3 = F.fq2_sub(F.fq2_sub(F.fq2_sq(F.fq2_add(Y, Z)), YY), ZZ)
    Y3 = F.fq2_sub(F.fq2_mul(M, F.fq2_sub(S, X3)), F.fq2_scalar(YYYY, 8))
    Zt3 = F.fq2_mul(ZZ, Z)
    c0 = F.fq2_scalar(F.fq2_mul(Y, Zt3), (-2 * yp) % P)
    c1 = F.fq2_scalar(F.fq2_mul(XX, ZZ), 3 * xp % P)
    c3 = F.fq2_sub(F.fq2_scalar(YY, 2), F.fq2_scalar(F.fq2_mul(XX, X), 3))
    return (X3, Y3, Z3), (c0, c1, c3)


def _add_step(t, q, xp: int, yp: int):
    """Mixed Jacobian addition t + (xq, yq) over Fq2 + line coeffs.
    Line (scaled by H*Zt = Z3): -yp*Z3 @w0, R*xp @w1, (yq*Z3 - R*xq) @w3."""
    X, Y, Z = t
    xq, yq = q
    ZZ = F.fq2_sq(Z)
    U2 = F.fq2_mul(xq, ZZ)
    S2 = F.fq2_mul(F.fq2_mul(yq, ZZ), Z)
    H = F.fq2_sub(U2, X)
    R = F.fq2_sub(S2, Y)
    HH = F.fq2_sq(H)
    HHH = F.fq2_mul(H, HH)
    V = F.fq2_mul(X, HH)
    X3 = F.fq2_sub(F.fq2_sub(F.fq2_sq(R), HHH), F.fq2_scalar(V, 2))
    Y3 = F.fq2_sub(F.fq2_mul(R, F.fq2_sub(V, X3)), F.fq2_mul(Y, HHH))
    Z3 = F.fq2_mul(Z, H)
    c0 = F.fq2_scalar(Z3, (-yp) % P)
    c1 = F.fq2_scalar(R, xp)
    c3 = F.fq2_sub(F.fq2_mul(yq, Z3), F.fq2_mul(R, xq))
    return (X3, Y3, Z3), (c0, c1, c3)


def _frob_twist_coeffs():
    """gamma2, gamma3 with frob(w^2) = gamma2 * w^2, frob(w^3) = gamma3 * w^3,
    computed from the generic fq12 machinery (no hand-written constants)."""
    g2 = fq12_mul(fq12_frob(_W2, 1), fq12_inv(_W2))
    g3 = fq12_mul(fq12_frob(_W3, 1), fq12_inv(_W3))
    return g2[0][0], g3[0][0]


_G2_FROB_X, _G2_FROB_Y = _frob_twist_coeffs()


def _psi(q: G2Affine) -> G2Affine:
    """Untwist-Frobenius-twist endomorphism on G2 twist coordinates."""
    x, y = q
    return (F.fq2_mul(F.fq2_conj(x), _G2_FROB_X),
            F.fq2_mul(F.fq2_conj(y), _G2_FROB_Y))


def miller_loop(p: G1Affine, q: G2Affine) -> tuple:
    """f_{6x+2, Q}(P), optimal ate: Fq2 Jacobian steps, no inversions."""
    if p is None or q is None:
        return FQ12_ONE
    xp, yp = p
    t = (q[0], q[1], F.FQ2_ONE)
    f = FQ12_ONE
    for i in range(F.ATE_LOOP_COUNT.bit_length() - 2, -1, -1):
        t, (c0, c1, c3) = _dbl_step(t, xp, yp)
        f = fq12_mul(fq12_sq(f), _sparse013(c0, c1, c3))
        if (F.ATE_LOOP_COUNT >> i) & 1:
            t, (c0, c1, c3) = _add_step(t, q, xp, yp)
            f = fq12_mul(f, _sparse013(c0, c1, c3))
    q1 = _psi(q)
    q2 = _psi(q1)
    nq2 = (q2[0], F.fq2_neg(q2[1]))
    t, (c0, c1, c3) = _add_step(t, q1, xp, yp)
    f = fq12_mul(f, _sparse013(c0, c1, c3))
    t, (c0, c1, c3) = _add_step(t, nq2, xp, yp)
    f = fq12_mul(f, _sparse013(c0, c1, c3))
    return f


def multi_miller_loop(pairs: Iterable[Tuple[G1Affine, G2Affine]]) -> tuple:
    f = FQ12_ONE
    for p, q in pairs:
        if p is None or q is None:
            continue
        f = fq12_mul(f, miller_loop(p, q))
    return f


def _exp_by_x(f: tuple) -> tuple:
    """f^x for the BN parameter x (63 bits) — square-and-multiply."""
    return F.fq12_pow(f, F.BN_X)


def final_exponentiation(f: tuple) -> tuple:
    """f^((p^12-1)/r).  Easy part via conjugation/inversion + Frobenius;
    hard part with the BN addition-chain structure (three exponentiations by
    the 63-bit curve parameter x plus ~15 multiplies — reference
    engine.rs:460-560) instead of one ~3000-bit direct exponentiation:
    ~20x fewer Fq12 operations, which is most of verifier wall-clock."""
    # easy part: f^(p^6-1) then ^(p^2+1)
    f1 = fq12_mul(fq12_conj(f), fq12_inv(f))
    r = fq12_mul(fq12_frob(f1, 2), f1)
    # hard part on the cyclotomic subgroup (conjugate == inverse there)
    inv = fq12_conj
    fp1 = fq12_frob(r, 1)
    fp2 = fq12_frob(r, 2)
    fp3 = fq12_frob(r, 3)
    fu = _exp_by_x(r)
    fu2 = _exp_by_x(fu)
    fu3 = _exp_by_x(fu2)
    fu2p = fq12_frob(fu2, 1)
    fu3p = fq12_frob(fu3, 1)
    y0 = fq12_mul(fq12_mul(fp1, fp2), fp3)
    y1 = inv(r)
    y2 = fq12_frob(fu2, 2)
    y3 = inv(fq12_frob(fu, 1))
    y4 = inv(fq12_mul(fu, fu2p))
    y5 = inv(fu2)
    y6 = inv(fq12_mul(fu3, fu3p))
    t0 = fq12_mul(fq12_mul(fq12_sq(y6), y4), y5)
    t1 = fq12_mul(fq12_mul(y3, y5), t0)
    t0 = fq12_mul(t0, y2)
    t1 = fq12_sq(fq12_mul(fq12_sq(t1), t0))
    t0 = fq12_mul(t1, y1)
    t1 = fq12_mul(t1, y0)
    t0 = fq12_sq(t0)
    return fq12_mul(t1, t0)


def pairing(p: G1Affine, q: G2Affine) -> tuple:
    return final_exponentiation(miller_loop(p, q))


def pairing_check(pairs: Sequence[Tuple[G1Affine, G2Affine]]) -> bool:
    """prod e(Pi, Qi) == 1.  Dispatches to the C multi-Miller loop + final
    exponentiation (native/fieldops.c bn_pairing_check, ~14x the Python
    tower; bit-exact equality pinned in tests/test_native_pairing.py); the
    Python path below remains the oracle and the no-toolchain fallback."""
    from ..native_loader import native_pairing_check
    ok = native_pairing_check(pairs)
    if ok is not None:
        return ok
    return final_exponentiation(multi_miller_loop(pairs)) == FQ12_ONE


# --------------------------- PairingBatcher ---------------------------------

class PairingBatcher:
    """Merges many pairing equations prod e(Ai, Bi) = 1 into a minimal
    multi-Miller loop (reference arithmetic/curves/src/batch_pairing.rs:7-95).

    Each `add_pairing` call is one equation.  If the call shares a G2 point
    with anything already batched, the running challenge is bumped and the
    call's G1 sides are all scaled by it (a fresh disjoint equation needs no
    scaling); tuples are then merged by G2 point.
    """

    def __init__(self, challenge: int):
        self.challenge = challenge % FR_MOD
        self.running = 1
        self._g1_by_g2: dict = {}
        self._order: List[G2Affine] = []

    def add_pairing(self, pairs: Sequence[Tuple[G1Affine, G2Affine]]) -> None:
        is_present = any(g2 in self._g1_by_g2 for _, g2 in pairs)
        if is_present:
            self.running = (self.running * self.challenge) % FR_MOD
            pairs = [(g1_mul(g1, self.running), g2) for g1, g2 in pairs]
        for g1, g2 in pairs:
            if g2 in self._g1_by_g2:
                self._g1_by_g2[g2] = g1_add(self._g1_by_g2[g2], g1)
            else:
                self._g1_by_g2[g2] = g1
                self._order.append(g2)

    def finalize(self) -> List[Tuple[G1Affine, G2Affine]]:
        return [(self._g1_by_g2[k], k) for k in self._order]

    def check(self) -> bool:
        return pairing_check(self.finalize())
