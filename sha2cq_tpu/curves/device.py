"""Device G1 point arithmetic: branch-free Jacobian ops over Fq limbs.

The reference's G1 ops are the `new_curve_impl!` macro's scalar Rust
(arithmetic/curves/src/derive/curve.rs); here a *batch of points* is three
(16, *batch) uint32 Montgomery-limb arrays (X, Y, Z), the identity is Z == 0,
and add/double are complete via mask selection — no data-dependent branches,
as XLA requires.

Compile-size design: a unified add needs ~30 Fq products, but tracing 30
separate mont_mul bodies makes XLA choke (the MSM scan networks instantiate
this combiner many times).  Independent products are therefore *stacked* into
6 rounds of one batched mont_mul each — same FLOPs, 5x smaller HLO, and a
wider batch per kernel.

Used by the Pippenger MSM (ops/msm.py) whose inner reductions instantiate
this add as the combiner of log-depth scan networks.
"""
from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp

from ..fields import device as D
from ..fields.device import FQ, NLIMB

# A point batch: (X, Y, Z) Jacobian, each (16, *batch); Z=0 encodes identity.
PointArray = Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]


def identity_like(shape) -> PointArray:
    zero = D.zeros(shape, FQ)
    one = D.ones(shape, FQ)
    return (one, one, zero)


def is_identity(p: PointArray):
    return D.is_zero(p[2])


def _mulround(pairs):
    """One batched Montgomery multiply for a list of independent products.
    pairs: [(a, b), ...] with equal shapes; returns list of products."""
    k = len(pairs)
    a = jnp.concatenate([p[0] for p in pairs], axis=-1)
    b = jnp.concatenate([p[1] for p in pairs], axis=-1)
    r = D.mont_mul(a, b, FQ)
    w = pairs[0][0].shape[-1]
    return [r[..., i * w:(i + 1) * w] for i in range(k)]


def _add(a, b):
    return D.add(a, b, FQ)


def _sub(a, b):
    return D.sub(a, b, FQ)


def _dbl2(a):
    return D.add(a, a, FQ)


def point_double(p: PointArray) -> PointArray:
    """Jacobian doubling (dbl-2009-l, a = 0).  Identity-safe: Z=0 -> Z3=0."""
    X, Y, Z = p
    A, B, ZZ = _mulround([(X, X), (Y, Y), (Y, Z)])
    C, t = _mulround([(B, B), (_add(X, B), _add(X, B))])
    Dd = _dbl2(_sub(_sub(t, A), C))
    E = _add(_dbl2(A), A)
    F, = _mulround([(E, E)])
    X3 = _sub(F, _dbl2(Dd))
    Y3a, = _mulround([(E, _sub(Dd, X3))])
    C8 = _dbl2(_dbl2(_dbl2(C)))
    Y3 = _sub(Y3a, C8)
    Z3 = _dbl2(ZZ)
    return (X3, Y3, Z3)


def point_add(p: PointArray, q: PointArray) -> PointArray:
    """Complete unified Jacobian addition (add-2007-bl + masked edge cases).

    Handles p/q identity, p == q (double leg, fused into the same multiply
    rounds), p == -q (identity result).  6 batched mont_mul rounds total.
    """
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q

    # r1: squares for both legs
    Z1Z1, Z2Z2, A, B = _mulround([(Z1, Z1), (Z2, Z2), (X1, X1), (Y1, Y1)])
    E = _add(_dbl2(A), A)  # 3A (double leg)

    # r2: cross terms + double-leg squares
    XB = _add(X1, B)
    U1, U2, ZA, ZB, C, t, F, YZ = _mulround([
        (X1, Z2Z2), (X2, Z1Z1), (Z2, Z2Z2), (Z1, Z1Z1),
        (B, B), (XB, XB), (E, E), (Y1, Z1),
    ])
    Dd = _dbl2(_sub(_sub(t, A), C))
    X3d = _sub(F, _dbl2(Dd))
    Z3d = _dbl2(YZ)

    # r3
    S1, S2, Y3d_ = _mulround([(Y1, ZA), (Y2, ZB), (E, _sub(Dd, X3d))])
    Y3d = _sub(Y3d_, _dbl2(_dbl2(_dbl2(C))))
    H = _sub(U2, U1)
    r = _sub(S2, S1)

    # r4
    HH, rr = _mulround([(H, H), (r, r)])
    # r5
    HHH, V, ZZ12 = _mulround([(H, HH), (U1, HH), (Z1, Z2)])
    X3 = _sub(_sub(rr, HHH), _dbl2(V))
    # r6
    T1, T2, Z3 = _mulround([(r, _sub(V, X3)), (S1, HHH), (ZZ12, H)])
    Y3 = _sub(T1, T2)

    # edge-case masking
    h_zero = D.is_zero(H)
    r_zero = D.is_zero(r)
    p_inf = D.is_zero(Z1)
    q_inf = D.is_zero(Z2)

    iX, iY, iZ = identity_like(X3.shape[1:])
    same = h_zero & ~p_inf & ~q_inf
    X3 = D.select(same & r_zero, X3d, D.select(same & ~r_zero, iX, X3))
    Y3 = D.select(same & r_zero, Y3d, D.select(same & ~r_zero, iY, Y3))
    Z3 = D.select(same & r_zero, Z3d, D.select(same & ~r_zero, iZ, Z3))
    X3 = D.select(p_inf, X2, D.select(q_inf & ~p_inf, X1, X3))
    Y3 = D.select(p_inf, Y2, D.select(q_inf & ~p_inf, Y1, Y3))
    Z3 = D.select(p_inf, Z2, D.select(q_inf & ~p_inf, Z1, Z3))
    return (X3, Y3, Z3)


def point_neg(p: PointArray) -> PointArray:
    X, Y, Z = p
    return (X, D.neg(Y, FQ), Z)


def select_point(mask, p: PointArray, q: PointArray) -> PointArray:
    return tuple(D.select(mask, a, b) for a, b in zip(p, q))


# ----------------------- host conversion helpers ----------------------------

def pack_affine(points) -> PointArray:
    """List of host affine points (or None) -> device Jacobian batch."""
    xs = [0 if pt is None else pt[0] for pt in points]
    ys = [1 if pt is None else pt[1] for pt in points]
    zs = [0 if pt is None else 1 for pt in points]
    return (D.pack(xs, FQ), D.pack(ys, FQ), D.pack(zs, FQ))


def unpack_jacobian(p: PointArray):
    """Device Jacobian batch -> list of host affine points (None = identity)."""
    from ..fields.host import FQ_MOD, inv_mod
    X = D.unpack(p[0], FQ)
    Y = D.unpack(p[1], FQ)
    Z = D.unpack(p[2], FQ)
    out = []
    for x, y, z in zip(X, Y, Z):
        if z == 0:
            out.append(None)
            continue
        zi = inv_mod(z, FQ_MOD)
        zi2 = zi * zi % FQ_MOD
        out.append((x * zi2 % FQ_MOD, y * zi2 * zi % FQ_MOD))
    return out
