"""Device (JAX) finite-field arithmetic for BN254.

Design:

* A field element is sixteen 16-bit limbs held in uint32 lanes.  16x16->32-bit
  limb products are exact in uint32; product columns are accumulated with
  *deferred carries* (column magnitudes stay < 2^23 << 2^32), and carries are
  propagated in short sequential chains.  This replaces the reference's 4x64
  Montgomery form (arithmetic/curves/src/derive/field.rs:345-464) with a
  layout that needs no 64-bit multiply.

* Arrays are **limbs-leading**: shape (16, *batch).  The batch axis is
  trailing and contiguous, so consecutive GPU threads read consecutive
  elements of one limb.  All ops are elementwise in the batch dims => XLA
  fuses the whole limb pipeline into a handful of loops.

* Montgomery representation (R = 2^256): mont_mul(a, b) = a*b*R^{-1} mod p,
  same convention as the reference field macros, so golden values can be
  cross-checked limb-for-limb against fields/host.py.

Two moduli are instantiated: Fr (scalar field; NTT/witness math) and Fq
(base field; G1 point coordinates inside the MSM).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, field
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

from . import host

NLIMB = 16          # limbs per element
LIMB_BITS = 16
MASK = (1 << LIMB_BITS) - 1
U32 = jnp.uint32


def _int_to_limbs(x: int) -> np.ndarray:
    return np.array([(x >> (LIMB_BITS * i)) & MASK for i in range(NLIMB)], dtype=np.uint32)


@dataclass(frozen=True)
class FieldCtx:
    """Static per-modulus constants baked into jitted kernels."""
    p: int
    name: str
    p_limbs: np.ndarray = field(repr=False, default=None)
    n0: int = 0                 # -p^{-1} mod 2^16 (Montgomery digit constant)
    r: int = 0                  # R mod p
    r2: int = 0                 # R^2 mod p
    r_limbs: np.ndarray = field(repr=False, default=None)
    r2_limbs: np.ndarray = field(repr=False, default=None)
    wide: bool = False          # p > 2^255: REDC result may overflow 2^256

    @staticmethod
    def make(p: int, name: str) -> "FieldCtx":
        n0 = (-pow(p, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)
        r = (1 << 256) % p
        r2 = (r * r) % p
        return FieldCtx(
            p=p, name=name,
            p_limbs=_int_to_limbs(p), n0=n0, r=r, r2=r2,
            r_limbs=_int_to_limbs(r), r2_limbs=_int_to_limbs(r2),
            wide=p > (1 << 255),
        )


FR = FieldCtx.make(host.FR_MOD, "Fr")
FQ = FieldCtx.make(host.FQ_MOD, "Fq")


# ------------------------- host <-> device conversion -----------------------

def pack(values: Sequence[int], ctx: FieldCtx, mont: bool = True) -> jnp.ndarray:
    """ints -> uint32[16, n] device array (Montgomery form by default)."""
    return jnp.asarray(np_pack(values, ctx, mont=mont))


def _native_lib(ctx: FieldCtx, n: int):
    """The OpenMP C kernels (native/fieldops.c) when usable for this field:
    the Python big-int Montgomery conversions are the device prover's main
    host-side overhead (h_pack_inputs/h_unpack ~0.4 s at k=14), so pack/
    unpack route the per-element modmul through fr_vec_scale."""
    if ctx.name != "Fr" or n < 256:
        return None
    try:
        from .. import native_loader as NL
        return NL if NL.get_lib() is not None else None
    except Exception:  # pragma: no cover
        return None


def unpack(arr, ctx: FieldCtx, mont: bool = True) -> list:
    """uint32[16, *batch] -> list of ints (flattened batch, C order)."""
    a = np.asarray(jax.device_get(arr)).reshape(NLIMB, -1)
    n = a.shape[1]
    NL = _native_lib(ctx, n)
    if NL is not None and (a <= 0xFFFF).all():
        # (16, n) uint32 16-bit limbs -> (n, 4) u64 buffer; one C pass for
        # the Montgomery exit (x * R^{-1} via fr_vec_scale), bytes -> ints.
        # The u16 view requires canonical 16-bit limbs (the astype would
        # silently truncate larger values — checked above; non-canonical
        # arrays fall through to the object-int fold below).
        buf = np.ascontiguousarray(a.T.astype("<u2")).view("<u8")
        # fr_vec_scale computes vals*c mod p PLAIN (it Montgomery-converts c
        # internally, fieldops.c:1079-1081), so mont exit passes c = R^{-1}
        # and the mont=False identity passes c = 1 (NOT R — that returned
        # x*R mod p and silently diverged from the <256-element fallback)
        scale = pow(ctx.r, ctx.p - 2, ctx.p) if mont else 1
        NL.get_lib().fr_vec_scale(NL._u64p(buf), NL._u64p(NL.fr_buf([scale])), n)
        return NL._np_from_u64_limbs(buf)
    acc = np.zeros(n, dtype=object)
    for i in range(NLIMB):
        acc |= a[i].astype(object) << (LIMB_BITS * i)
    if mont:
        rinv = pow(ctx.r, ctx.p - 2, ctx.p)
        return [(int(v) * rinv) % ctx.p for v in acc]
    return [int(v) % ctx.p for v in acc]


def unpack_buf(arr, ctx: FieldCtx, mont: bool = True) -> "np.ndarray":
    """uint32[16, *batch] -> (n, 4) canonical u64 limb buffer (flattened
    batch, C order) — the buffer-resident sibling of unpack(): downstream
    consumers (gwc folds, native Horner evals, multi-MSMs) operate on limb
    buffers, so skipping the bigint round trip saves ~2 s/proof of
    conversions at SHA-256 k=13 shapes."""
    a = np.asarray(jax.device_get(arr)).reshape(NLIMB, -1)
    n = a.shape[1]
    NL = _native_lib(ctx, n)
    if NL is not None and (a <= 0xFFFF).all():
        buf = np.ascontiguousarray(a.T.astype("<u2")).view("<u8")
        scale = pow(ctx.r, ctx.p - 2, ctx.p) if mont else 1
        NL.get_lib().fr_vec_scale(NL._u64p(buf), NL._u64p(NL.fr_buf([scale])), n)
        return buf
    from ..native_loader import _np_u64_limbs
    return _np_u64_limbs(unpack(arr, ctx, mont=mont), 4)


def pack_scalar(v: int, ctx: FieldCtx, mont: bool = True) -> jnp.ndarray:
    return pack([v], ctx, mont=mont)[:, 0]


def zeros(batch_shape, ctx: FieldCtx = FR) -> jnp.ndarray:
    return jnp.zeros((NLIMB, *batch_shape), dtype=U32)


def ones(batch_shape, ctx: FieldCtx = FR) -> jnp.ndarray:
    """Montgomery one (= R mod p) broadcast over the batch."""
    one = jnp.asarray(ctx.r_limbs, dtype=U32).reshape((NLIMB,) + (1,) * len(batch_shape))
    return jnp.broadcast_to(one, (NLIMB, *batch_shape)).astype(U32)


def const_array(ctx: FieldCtx, value: int, batch_shape=()) -> jnp.ndarray:
    """Montgomery-form constant broadcast to a batch shape."""
    v = (value % ctx.p) * ctx.r % ctx.p
    limbs = jnp.asarray(_int_to_limbs(v), dtype=U32).reshape((NLIMB,) + (1,) * len(batch_shape))
    return jnp.broadcast_to(limbs, (NLIMB, *batch_shape)).astype(U32)


def _pconst(ctx: FieldCtx, a):
    """Modulus limbs broadcast against a's batch shape, built from scalar
    constants (not a captured array)."""
    shape = (1,) * (a.ndim - 1)
    return jnp.stack([jnp.full(shape, np.uint32(int(x)), dtype=U32)
                      for x in ctx.p_limbs])


# ------------------------------ core kernels --------------------------------
# All kernels take/return uint32[16, *batch]; they are pure jnp so XLA fuses
# them.

def _carry_canonicalize(cols, nout: int):
    """Propagate carries over a list of uint32 columns -> nout 16-bit limbs.
    Returns (limbs list, final carry)."""
    out = []
    carry = None
    for i in range(nout):
        v = cols[i] if i < len(cols) else jnp.zeros_like(cols[0])
        if carry is not None:
            v = v + carry
        out.append(v & MASK)
        carry = v >> LIMB_BITS
    return out, carry


def _geq(a_limbs, b_limbs):
    """a >= b over 16-bit limb lists (little-endian), branch-free."""
    ge = None
    for i in range(len(a_limbs)):
        ai, bi = a_limbs[i], b_limbs[i]
        gt_i = ai > bi
        eq_i = ai == bi
        if ge is None:
            ge = gt_i | eq_i
        else:
            ge = gt_i | (eq_i & ge)
    return ge


def _sub_limbs(a_limbs, b_limbs):
    """a - b mod 2^256 over limb lists with borrow chain."""
    out = []
    borrow = jnp.zeros_like(a_limbs[0])
    for i in range(len(a_limbs)):
        v = a_limbs[i] - b_limbs[i] - borrow
        out.append(v & MASK)
        borrow = (v >> 31) & 1  # negative in uint32 arith => top bit set
    return out, borrow


def _stack(limbs) -> jnp.ndarray:
    return jnp.stack(limbs, axis=0).astype(U32)


def _unstack(a) -> list:
    return [a[i] for i in range(a.shape[0])]


def add(a, b, ctx: FieldCtx = FR):
    """(a + b) mod p."""
    al, bl = _unstack(a), _unstack(b)
    s = [x + y for x, y in zip(al, bl)]
    s, carry = _carry_canonicalize(s, NLIMB)
    pl = _unstack(_pconst(ctx, a) + jnp.zeros_like(a))
    d, borrow = _sub_limbs(s, pl)
    need_sub = (carry > 0) | _geq(s, pl)
    return _stack([jnp.where(need_sub, x, y) for x, y in zip(d, s)])


def sub(a, b, ctx: FieldCtx = FR):
    """(a - b) mod p."""
    al, bl = _unstack(a), _unstack(b)
    d, borrow = _sub_limbs(al, bl)
    pl = _unstack(_pconst(ctx, a) + jnp.zeros_like(a))
    dp = [x + y for x, y in zip(d, pl)]
    dp, _ = _carry_canonicalize(dp, NLIMB)
    under = borrow > 0
    return _stack([jnp.where(under, x, y) for x, y in zip(dp, d)])


def neg(a, ctx: FieldCtx = FR):
    return sub(jnp.zeros_like(a), a, ctx)


def is_zero(a):
    """Boolean mask over the batch dims: a == 0 (all limbs zero)."""
    return jnp.all(a == 0, axis=0)


def eq(a, b):
    return jnp.all(a == b, axis=0)


def select(mask, a, b):
    """mask ? a : b  (mask over batch dims)."""
    return jnp.where(mask[None, ...], a, b)


# mont_mul formulations.  Both compute the identical REDC digit sequence, so
# results are bit-identical; the choice trades compile time against run time.
# mont_mul uses the compact lax.scan form (~100 HLO per multiply) on every
# backend:
#   cpu: the unrolled form expands to ~2-3k HLO ops per multiply and XLA:CPU
#        compile time is superlinear in module size (graphs with dozens of
#        muls took 5-30 min).
#   gpu: on an H100 the unrolled form multiplies ~3x faster at 2^20 but
#        compiles ~8x slower; in the k=13 SHA-256 h program it cuts the
#        warm h from 182 to 73 ms but adds ~100 s of compile, and the warm
#        prove (host-bound, ~2.0 s) does not move (PERF.md, Findings,
#        "mont_mul form").  The unrolled form stays as the cross-check and
#        the lever for cells where h dominates.


def _mont_mul_compact(a, b, ctx: FieldCtx):
    """lax.scan CIOS Montgomery multiply.

    Per step i: acc += a_i*b (lo/hi split) + m*p with m = (-acc0/p) mod 2^16,
    push acc0's carry, shift the accumulator down one limb.  Column
    magnitudes stay < 2^23 (16 iterations x ~4*2^16 per column), products are
    exact 16x16->32.  Result = (a*b + m(X)*p)/2^256 < 2p for canonical b
    (same contract and same final value as the register form)."""
    batch = jnp.broadcast_shapes(a.shape[1:], b.shape[1:])
    a = jnp.broadcast_to(a, (NLIMB, *batch))
    b = jnp.broadcast_to(b, (NLIMB, *batch))
    ones = (1,) * len(batch)
    p_arr = jnp.asarray(ctx.p_limbs, dtype=U32).reshape(NLIMB, *ones)
    n0 = np.uint32(ctx.n0)
    # derive the zero carry from the inputs (a & 0) so that under shard_map
    # its varying-manual-axes type matches the scan body's output — a plain
    # zeros() constant is unvarying and the scan rejects the carry mismatch
    acc0 = jnp.zeros((NLIMB + 2, *batch), dtype=U32) + (a[:1] & jnp.uint32(0))

    def step(acc, a_i):
        prod = a_i[None] * b
        acc = acc.at[:NLIMB].add(prod & MASK)
        acc = acc.at[1:NLIMB + 1].add(prod >> LIMB_BITS)
        m = ((acc[0] & MASK) * n0) & MASK
        prodm = m[None] * p_arr
        acc = acc.at[:NLIMB].add(prodm & MASK)
        acc = acc.at[1:NLIMB + 1].add(prodm >> LIMB_BITS)
        acc = acc.at[1].add(acc[0] >> LIMB_BITS)
        acc = jnp.concatenate([acc[1:], jnp.zeros_like(acc[:1])], axis=0)
        return acc, None

    acc, _ = jax.lax.scan(step, acc0, a)
    limbs, _ = _carry_canonicalize([acc[i] for i in range(NLIMB + 1)],
                                   NLIMB + 1)
    hi = limbs[NLIMB]
    limbs = limbs[:NLIMB]  # result < 2p fits 16 limbs when p < 2^255
    plc = [jnp.full_like(limbs[0], x) for x in ctx.p_limbs]
    d, _ = _sub_limbs(limbs, plc)
    need_sub = _geq(limbs, plc)
    if ctx.wide:
        need_sub = need_sub | (hi > 0)  # see mont_mul: wide-modulus overflow
    return _stack([jnp.where(need_sub, x, y) for x, y in zip(d, limbs)])


def mont_mul(a, b, ctx: FieldCtx = FR):
    """Montgomery product a*b*R^{-1} mod p (the compact form, see above)."""
    return _mont_mul_compact(a, b, ctx)


def _mont_mul_unrolled(a, b, ctx: FieldCtx):
    """Schoolbook 16x16 limb products with lo/hi split and deferred-carry
    column accumulation, followed by digit-wise Montgomery reduction
    (operand-scanning REDC with base 2^16).  Column magnitudes stay < 2^23.

    Columns are held as individual (batch,) arrays ("registers") rather than
    one (33, batch) array updated with dynamic-update-slices, so XLA can keep
    columns in registers and fuse the adds into one loop.
    """
    batch = jnp.broadcast_shapes(a.shape[1:], b.shape[1:])
    a = jnp.broadcast_to(a, (NLIMB, *batch))
    b = jnp.broadcast_to(b, (NLIMB, *batch))
    zero = jnp.zeros(batch, dtype=U32)
    cols = [zero] * (2 * NLIMB + 1)
    for i in range(NLIMB):
        pij = a[i][None, ...] * b            # (16, batch) exact u32 products
        los = pij & MASK
        his = pij >> LIMB_BITS
        for j in range(NLIMB):
            cols[i + j] = cols[i + j] + los[j]
            cols[i + j + 1] = cols[i + j + 1] + his[j]
    # REDC: 16 digit steps
    n0 = np.uint32(ctx.n0)
    plimb = [np.uint32(int(x)) for x in ctx.p_limbs]
    for i in range(NLIMB):
        m = (cols[i] * n0) & MASK
        for j in range(NLIMB):
            mp = m * plimb[j]
            cols[i + j] = cols[i + j] + (mp & MASK)
            cols[i + j + 1] = cols[i + j + 1] + (mp >> LIMB_BITS)
        # cols[i] is now 0 mod 2^16; push its carry up
        cols[i + 1] = cols[i + 1] + (cols[i] >> LIMB_BITS)
    res_cols = [cols[NLIMB + i] for i in range(NLIMB + 1)]
    limbs, carry = _carry_canonicalize(res_cols, NLIMB + 1)
    hi = limbs[NLIMB]          # t < 2p: one overflow bit when p > 2^255
    limbs = limbs[:NLIMB]
    plc = [jnp.full_like(limbs[0], x) for x in ctx.p_limbs]
    d, borrow = _sub_limbs(limbs, plc)
    need_sub = _geq(limbs, plc)
    if ctx.wide:
        # p > 2^255 (e.g. secp256k1 Fp/Fq): t can exceed 2^256; the 16-limb
        # wraparound difference is the correct low 256 bits of t - p
        need_sub = need_sub | (hi > 0)
    return _stack([jnp.where(need_sub, x, y) for x, y in zip(d, limbs)])


def mont_sq(a, ctx: FieldCtx = FR):
    return mont_mul(a, a, ctx)


def to_mont(a, ctx: FieldCtx = FR):
    """standard form -> Montgomery form (multiply by R^2 then REDC)."""
    r2 = jnp.broadcast_to(
        jnp.asarray(ctx.r2_limbs, dtype=U32).reshape((NLIMB,) + (1,) * (a.ndim - 1)),
        a.shape,
    )
    return mont_mul(a, r2, ctx)


def from_mont(a, ctx: FieldCtx = FR):
    """Montgomery form -> standard form (REDC against 1)."""
    one = jnp.zeros_like(a).at[0].set(1)
    return mont_mul(a, one, ctx)


def pow_const(a, e: int, ctx: FieldCtx = FR):
    """a^e for a host-known exponent (square-and-multiply, unrolled over the
    ~254 exponent bits inside a fori_loop: one squaring + one masked multiply
    per step; runs on the whole batch at once)."""
    if e == 0:
        return ones(a.shape[1:], ctx)
    nbits = e.bit_length()
    bits = jnp.asarray([(e >> (nbits - 1 - i)) & 1 for i in range(nbits)], dtype=jnp.uint32)

    def body(i, acc):
        acc = mont_sq(acc, ctx)
        mul = mont_mul(acc, a, ctx)
        return select(bits[i] == 1, mul, acc)

    # first bit is always 1 => start from a
    return jax.lax.fori_loop(1, nbits, body, a)


def inv(a, ctx: FieldCtx = FR):
    """Elementwise inverse via Fermat (a^{p-2}); inverse of 0 is 0."""
    r = pow_const(a, ctx.p - 2, ctx)
    return select(is_zero(a), jnp.zeros_like(a), r)


# ------------------------------ convenience ---------------------------------

def mul_scalar(a, scalar_limbs, ctx: FieldCtx = FR):
    """Multiply a whole array by one Montgomery-form scalar (16,)."""
    return mont_mul(a, scalar_limbs.reshape((NLIMB,) + (1,) * (a.ndim - 1)), ctx)


def np_pack_buf(buf: np.ndarray, ctx: FieldCtx, mont: bool = True) -> np.ndarray:
    """(n, 4) canonical u64 limb buffer -> uint32[16, n] (Montgomery by
    default) without the bigint round trip of np_pack."""
    n = buf.shape[0]
    NL = _native_lib(ctx, n)
    if NL is None:
        from ..native_loader import _np_from_u64_limbs
        return np_pack(_np_from_u64_limbs(buf), ctx, mont=mont)
    work = np.ascontiguousarray(buf).copy()
    if mont:
        NL.get_lib().fr_vec_scale(
            NL._u64p(work), NL._u64p(NL.fr_buf([ctx.r % ctx.p])), n)
    return np.ascontiguousarray(
        work.view("<u2").reshape(n, NLIMB).T).astype(np.uint32)


def np_pack(values: Sequence[int], ctx: FieldCtx, mont: bool = True) -> np.ndarray:
    """ints -> uint32[16, n] numpy array (Montgomery form by default)."""
    n = len(values)
    NL = _native_lib(ctx, n)
    if NL is not None:
        # ints -> (n, 4) u64 via one bytes round trip (int.to_bytes runs at
        # C speed), Montgomery entry (x * R) in one C pass, u16 view -> limbs
        buf = NL._np_u64_limbs([v % ctx.p for v in values], 4)
        if mont:
            NL.get_lib().fr_vec_scale(
                NL._u64p(buf), NL._u64p(NL.fr_buf([ctx.r % ctx.p])), n)
        return np.ascontiguousarray(buf.view("<u2").reshape(n, NLIMB).T
                                    ).astype(np.uint32)
    vals = np.array([v % ctx.p for v in values], dtype=object)
    if mont:
        vals = (vals * ctx.r) % ctx.p
    arr = np.zeros((NLIMB, len(values)), dtype=np.uint32)
    for i in range(NLIMB):
        arr[i] = ((vals >> (LIMB_BITS * i)) & MASK).astype(np.uint32)
    return arr
