"""Host-side (CPU, arbitrary-precision int) BN254 field tower.

This is the *oracle and verifier* layer of the framework: verification is
O(proof size) and inherently sequential (one multi-Miller loop), so it lives
on the host; the device (JAX) layer in `fields/device.py` carries the
prover's bulk arithmetic and is tested bit-exactly against this module.

Capability parity with the reference:
  - BN254 scalar field Fr / base field Fq  (reference: arithmetic/curves/src/bn256/{fr,fq}.rs)
  - extension tower Fq2 = Fq[u]/(u^2+1), Fq6 = Fq2[v]/(v^3 - xi), xi = 9+u,
    Fq12 = Fq6[w]/(w^2 - v)                (reference: bn256/{fq2,fq6,fq12}.rs)
  - constants: 2-adicity roots of unity, ZETA, DELTA, etc. (fr.rs:28-60)

Design note: host fields are plain Python ints mod p — no
Montgomery form is needed off-device.  Montgomery limb representation only
exists on the device side where the hardware (no 64-bit multiply) demands it.
"""
from __future__ import annotations

# BN254 (alt_bn128) parameters
FR_MOD = 21888242871839275222246405745257275088548364400416034343698204186575808495617
FQ_MOD = 21888242871839275222246405745257275088696311157297823662689037894645226208583

# BN curve parameter t: p(t), r(t) per the BN family; 6t+2 drives the ate loop.
BN_X = 4965661367192848881
ATE_LOOP_COUNT = 6 * BN_X + 2  # 29793968203157093288

# Fr multiplicative generator and 2-adicity (reference bn256/fr.rs:
# S = 28, GENERATOR = 7)
FR_S = 28
FR_GENERATOR = 7
FR_ROOT_OF_UNITY = pow(FR_GENERATOR, (FR_MOD - 1) >> FR_S, FR_MOD)
FR_ROOT_OF_UNITY_INV = pow(FR_ROOT_OF_UNITY, FR_MOD - 2, FR_MOD)
# DELTA = GENERATOR^{2^S} — generator of the group of order (r-1)/2^S
FR_DELTA = pow(FR_GENERATOR, 1 << FR_S, FR_MOD)
# ZETA: primitive cube root of unity in Fr (used for the extended-domain coset
# and GLV). The reference pins a specific cube root (bn256/fr.rs ZETA); we pin
# the same canonical choice: g^((r-1)/3) for g = 7 gives one of the two
# nontrivial roots; the halo2 EvaluationDomain only requires zeta^3 = 1,
# zeta != 1 (poly/domain.rs g_coset construction).
FR_ZETA = pow(FR_GENERATOR, (FR_MOD - 1) // 3, FR_MOD)
FR_TWO_INV = pow(2, FR_MOD - 2, FR_MOD)

R_FR = (1 << 256) % FR_MOD   # Montgomery R for the device layer
R_FQ = (1 << 256) % FQ_MOD


def fr(x: int) -> int:
    return x % FR_MOD


def fq(x: int) -> int:
    return x % FQ_MOD


def inv_mod(x: int, p: int) -> int:
    if x % p == 0:
        raise ZeroDivisionError("field inversion of zero")
    return pow(x, p - 2, p)


def fr_inv(x: int) -> int:
    return inv_mod(x, FR_MOD)


def fq_inv(x: int) -> int:
    return inv_mod(x, FQ_MOD)


def batch_inv(xs, p: int):
    """Montgomery batch inversion of a list of ints mod p (zeros -> zero),
    mirrors halo2's BatchInvert semantics.  Fr batches of >= 256 route to
    the native kernel (native/fieldops.c fr_batch_inv) — witness grids and
    the CQ A/B denominators are tens of thousands of inversions per proof."""
    n = len(xs)
    if p == FR_MOD and n >= 256:
        from ..native_loader import native_fr_batch_inv
        out = native_fr_batch_inv([x % p for x in xs])
        if out is not None:
            return out
    prods = [1] * n
    acc = 1
    for i, x in enumerate(xs):
        prods[i] = acc
        if x % p != 0:
            acc = (acc * x) % p
    acc = inv_mod(acc, p)
    out = [0] * n
    for i in range(n - 1, -1, -1):
        x = xs[i] % p
        if x != 0:
            out[i] = (acc * prods[i]) % p
            acc = (acc * x) % p
    return out


def sqrt_mod(a: int, p: int):
    """Tonelli–Shanks square root mod p; returns None if a is a non-residue."""
    a %= p
    if a == 0:
        return 0
    if pow(a, (p - 1) // 2, p) != 1:
        return None
    if p % 4 == 3:
        return pow(a, (p + 1) // 4, p)
    # general Tonelli-Shanks
    s, q = 0, p - 1
    while q % 2 == 0:
        s += 1
        q //= 2
    z = 2
    while pow(z, (p - 1) // 2, p) != p - 1:
        z += 1
    m, c, t, r = s, pow(z, q, p), pow(a, q, p), pow(a, (q + 1) // 2, p)
    while t != 1:
        i, t2 = 0, t
        while t2 != 1:
            t2 = (t2 * t2) % p
            i += 1
        b = pow(c, 1 << (m - i - 1), p)
        m, c = i, (b * b) % p
        t, r = (t * c) % p, (r * b) % p
    return r


# ---------------------------------------------------------------------------
# Extension tower.  Elements are immutable tuples of ints; all ops are module
# functions (tuple-based is ~3x faster than classes in CPython and the
# verifier's Miller loop is the hot host path).
#
# Fq2  = (c0, c1)            meaning c0 + c1*u,  u^2 = -1
# Fq6  = (a0, a1, a2)        ai in Fq2, v^3 = xi = 9 + u
# Fq12 = (b0, b1)            bi in Fq6, w^2 = v
# ---------------------------------------------------------------------------

P = FQ_MOD
XI = (9, 1)  # 9 + u

FQ2_ZERO = (0, 0)
FQ2_ONE = (1, 0)


def fq2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def fq2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def fq2_neg(a):
    return ((-a[0]) % P, (-a[1]) % P)


def fq2_mul(a, b):
    # (a0 + a1 u)(b0 + b1 u) = a0b0 - a1b1 + (a0b1 + a1b0) u
    t0 = a[0] * b[0]
    t1 = a[1] * b[1]
    t2 = (a[0] + a[1]) * (b[0] + b[1])
    return ((t0 - t1) % P, (t2 - t0 - t1) % P)


def fq2_sq(a):
    # (a0+a1 u)^2 = (a0+a1)(a0-a1) + 2 a0 a1 u
    t0 = (a[0] + a[1]) * (a[0] - a[1])
    t1 = 2 * a[0] * a[1]
    return (t0 % P, t1 % P)


def fq2_scalar(a, k: int):
    return ((a[0] * k) % P, (a[1] * k) % P)


def fq2_conj(a):
    return (a[0], (-a[1]) % P)


def fq2_inv(a):
    # 1/(a0 + a1 u) = (a0 - a1 u)/(a0^2 + a1^2)
    norm = (a[0] * a[0] + a[1] * a[1]) % P
    ninv = inv_mod(norm, P)
    return ((a[0] * ninv) % P, ((-a[1]) * ninv) % P)


def fq2_mul_xi(a):
    # multiply by xi = 9 + u: (9 a0 - a1) + (a0 + 9 a1) u
    return ((9 * a[0] - a[1]) % P, (a[0] + 9 * a[1]) % P)


def fq2_pow(a, e: int):
    result = FQ2_ONE
    base = a
    while e:
        if e & 1:
            result = fq2_mul(result, base)
        base = fq2_sq(base)
        e >>= 1
    return result


FQ6_ZERO = (FQ2_ZERO, FQ2_ZERO, FQ2_ZERO)
FQ6_ONE = (FQ2_ONE, FQ2_ZERO, FQ2_ZERO)


def fq6_add(a, b):
    return (fq2_add(a[0], b[0]), fq2_add(a[1], b[1]), fq2_add(a[2], b[2]))


def fq6_sub(a, b):
    return (fq2_sub(a[0], b[0]), fq2_sub(a[1], b[1]), fq2_sub(a[2], b[2]))


def fq6_neg(a):
    return (fq2_neg(a[0]), fq2_neg(a[1]), fq2_neg(a[2]))


def fq6_mul(a, b):
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = fq2_mul(a0, b0)
    t1 = fq2_mul(a1, b1)
    t2 = fq2_mul(a2, b2)
    c0 = fq2_add(t0, fq2_mul_xi(fq2_sub(fq2_mul(fq2_add(a1, a2), fq2_add(b1, b2)), fq2_add(t1, t2))))
    c1 = fq2_add(fq2_sub(fq2_mul(fq2_add(a0, a1), fq2_add(b0, b1)), fq2_add(t0, t1)), fq2_mul_xi(t2))
    c2 = fq2_add(fq2_sub(fq2_mul(fq2_add(a0, a2), fq2_add(b0, b2)), fq2_add(t0, t2)), t1)
    return (c0, c1, c2)


def fq6_sq(a):
    return fq6_mul(a, a)


def fq6_mul_by_v(a):
    # v * (a0 + a1 v + a2 v^2) = xi a2 + a0 v + a1 v^2
    return (fq2_mul_xi(a[2]), a[0], a[1])


def fq6_inv(a):
    a0, a1, a2 = a
    c0 = fq2_sub(fq2_sq(a0), fq2_mul_xi(fq2_mul(a1, a2)))
    c1 = fq2_sub(fq2_mul_xi(fq2_sq(a2)), fq2_mul(a0, a1))
    c2 = fq2_sub(fq2_sq(a1), fq2_mul(a0, a2))
    t = fq2_add(fq2_mul(a2, c1), fq2_mul(a1, c2))
    t = fq2_add(fq2_mul_xi(t), fq2_mul(a0, c0))
    tinv = fq2_inv(t)
    return (fq2_mul(c0, tinv), fq2_mul(c1, tinv), fq2_mul(c2, tinv))


FQ12_ZERO = (FQ6_ZERO, FQ6_ZERO)
FQ12_ONE = (FQ6_ONE, FQ6_ZERO)


def fq12_add(a, b):
    return (fq6_add(a[0], b[0]), fq6_add(a[1], b[1]))


def fq12_sub(a, b):
    return (fq6_sub(a[0], b[0]), fq6_sub(a[1], b[1]))


def fq12_mul(a, b):
    a0, a1 = a
    b0, b1 = b
    t0 = fq6_mul(a0, b0)
    t1 = fq6_mul(a1, b1)
    c0 = fq6_add(t0, fq6_mul_by_v(t1))
    c1 = fq6_sub(fq6_sub(fq6_mul(fq6_add(a0, a1), fq6_add(b0, b1)), t0), t1)
    return (c0, c1)


def fq12_sq(a):
    return fq12_mul(a, a)


def fq12_inv(a):
    a0, a1 = a
    t = fq6_sub(fq6_mul(a0, a0), fq6_mul_by_v(fq6_mul(a1, a1)))
    tinv = fq6_inv(t)
    return (fq6_mul(a0, tinv), fq6_neg(fq6_mul(a1, tinv)))


def fq12_conj(a):
    """Conjugation = Frobenius^6 (unitary inverse for elements on the cyclotomic
    subgroup after the easy part of the final exponentiation)."""
    return (a[0], fq6_neg(a[1]))


def fq12_pow(a, e: int):
    if e < 0:
        return fq12_pow(fq12_inv(a), -e)
    result = FQ12_ONE
    base = a
    while e:
        if e & 1:
            result = fq12_mul(result, base)
        base = fq12_sq(base)
        e >>= 1
    return result


# Frobenius coefficients: gamma1[i] = xi^{i (p-1)/6} in Fq2, used for the
# power-of-p maps on the tower (reference bn256/fq6.rs / fq12.rs Frobenius
# constants; computed here at import time rather than pinned as literals).
_G1 = [fq2_pow(XI, i * (P - 1) // 6) for i in range(6)]
# xi^{i (p^2-1)/6} — these land in Fq (the norm subfield)
_G2 = [fq2_pow(XI, i * (P * P - 1) // 6) for i in range(6)]


def fq6_frob(a, power: int = 1):
    """Frobenius x -> x^(p^power) on Fq6 (power 1 or 2)."""
    a0, a1, a2 = a
    if power == 1:
        return (
            fq2_conj(a0),
            fq2_mul(fq2_conj(a1), _G1[2]),
            fq2_mul(fq2_conj(a2), _G1[4]),
        )
    elif power == 2:
        return (a0, fq2_mul(a1, _G2[2]), fq2_mul(a2, _G2[4]))
    raise ValueError(power)


def fq12_frob(a, power: int = 1):
    """Frobenius x -> x^(p^power) on Fq12 (power 1, 2, 3)."""
    if power == 1:
        c0 = fq6_frob(a[0], 1)
        c1 = fq6_frob(a[1], 1)
        c1 = tuple(fq2_mul(x, _G1[1]) for x in c1)
        return (c0, c1)
    if power == 2:
        c0 = fq6_frob(a[0], 2)
        c1 = fq6_frob(a[1], 2)
        c1 = tuple(fq2_mul(x, _G2[1]) for x in c1)
        return (c0, c1)
    if power == 3:
        return fq12_frob(fq12_frob(a, 2), 1)
    raise ValueError(power)


def fq12_is_one(a) -> bool:
    return a == FQ12_ONE


def fq2_sqrt(a):
    """Square root in Fq2 = Fq[u]/(u^2+1) for q = 3 mod 4, or None.

    Algorithm (complex method): with n = a0^2 + a1^2 = Norm(a), a square
    root x = x0 + x1 u satisfies x0^2 = (a0 + s)/2 or (a0 - s)/2 for
    s = sqrt(n), and x1 = a1 / (2 x0); a is a square iff n is a square in
    Fq and one of the two candidates for x0^2 is.  Mirrors the reference's
    Fq2::sqrt (curves/src/bn256/fq2.rs)."""
    a0, a1 = a[0] % FQ_MOD, a[1] % FQ_MOD
    if a1 == 0:
        s = sqrt_mod(a0, FQ_MOD)
        if s is not None:
            return (s, 0)
        # a0 is a non-residue: sqrt(a0) = sqrt(-a0) * u  (since u^2 = -1)
        s = sqrt_mod((-a0) % FQ_MOD, FQ_MOD)
        return None if s is None else (0, s)
    n = (a0 * a0 + a1 * a1) % FQ_MOD
    s = sqrt_mod(n, FQ_MOD)
    if s is None:
        return None
    inv2 = inv_mod(2, FQ_MOD)
    d = (a0 + s) * inv2 % FQ_MOD
    x0 = sqrt_mod(d, FQ_MOD)
    if x0 is None:
        d = (a0 - s) * inv2 % FQ_MOD
        x0 = sqrt_mod(d, FQ_MOD)
        if x0 is None:
            return None
    x1 = a1 * inv_mod(2 * x0 % FQ_MOD, FQ_MOD) % FQ_MOD
    x = (x0, x1)
    if fq2_mul(x, x) != (a0, a1):
        return None
    return x
