"""Matmul NTT: DFT-as-int8-matmul over digit-decomposed field elements.

The butterfly NTT (ops/ntt.py) spends its time in 16x16-bit limb Montgomery
multiplies.  This module reformulates the radix-512 four-step NTT so that
the twiddle products become exact int8 x int8 -> int32 matrix products,
which XLA hands to the GPU's integer GEMM:

  * A size-m DFT (m <= 512) of field elements is ONE int8 matmul:
    every twiddle W[i,j] = omega^{ij} is pre-expanded into the 32 byte-digits
    of (W[i,j] * 2^{8b} mod p) for each input-digit position b — i.e. the
    mod-p reduction of digit cross-products is folded into the constant
    matrix.  The (32m x 32m) int8 matrix times the (32m x B) int8 digit
    matrix of the inputs yields 32 int32 output digit-planes directly
    (exact: |acc| <= 255*255*32*512 < 2^31).
  * int8 is signed, digits are unsigned bytes: both sides are stored
    offset by -128 and the exact correction  sum(m'x') + 128*rowsum(M') +
    128*colsum(X') + 128^2*K  is added back (all precomputed or O(B)).
  * The digit-planes are regrouped into 16-bit limbs with a
    carry sweep (elementwise; XLA fuses the chain); limbs beyond 2^256 are folded with precomputed
    2^{256+16i} mod p constants.  Intermediate values stay in a relaxed
    (< 2^256, possibly >= p) representation — only the final output is
    canonicalized — so the per-element epilogue is ~10x cheaper than a
    Montgomery multiply.
  * Sizes beyond 512 use the four-step split n = m1*512 recursively:
    local DFTs via the shared canonical W_512 matrix (the order-512 root
    derived from any standard 2^k domain is the same, so one matrix serves
    every k), a single elementwise twiddle Montgomery multiply, and a
    transposed second pass.
  * The (32m x 32m) matrices are ~268 MB; they are passed through the jit
    boundary as ARGUMENTS (a NttPlan pytree), never closure-captured, so
    compiled programs stay small and their cache keys depend on shapes only.

Semantics match ops/ntt.ntt == the reference best_fft
(halo2_proofs/src/arithmetic.rs:171-274): natural-order coefficients in,
natural-order evaluations at omega^0..omega^{n-1} out, Montgomery limb
format (16 x 16-bit) throughout.
"""
from __future__ import annotations

import functools
import hashlib
import os
from typing import List, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..fields import device as D
from ..fields import host as H
from ..fields.device import FR, LIMB_BITS, MASK, NLIMB, U32

NDIG = 32            # 8-bit digits per 256-bit element
MAX_MATMUL = 512     # largest DFT done as a single matmul


def auto_max_m(n: int) -> int:
    """Plan width: 1024 for n >= 2^20 (two 1024-wide levels instead of two
    512 levels plus a butterfly residual; the (32*1024)^2 int8 digit matrix
    is 1 GB of device memory, so it is only held for the sizes that need
    it)."""
    return 1024 if n >= (1 << 20) else MAX_MATMUL


class NttPlan(NamedTuple):
    """Device arrays for one (n, omega) NTT, passed through jit as args."""
    base_mat: jnp.ndarray       # (32*m2, 32*m2) int8 — shared inner DFT
    base_rowsum: jnp.ndarray    # (32*m2,) int32
    res_mat: jnp.ndarray        # residual outer DFT matrix
    res_rowsum: jnp.ndarray
    twiddles: Tuple[jnp.ndarray, ...]   # per level: (16, m2, m1) Montgomery


# ------------------------- host-side precomputation --------------------------

def _dft_digit_matrix_np(m: int, omega: int, p: int):
    """(32m, 32m) int8 digit matrix + (32m,) int32 row sums for the size-m DFT.

    Entry [(s, i), (j, b)] = byte_s(omega^{ij} * 2^{8b} mod p) - 128.
    Cached on disk: the m=512 build costs ~20s of host bigint work.
    """
    from .. import data_cache_dir
    tag = f"w{m}_{omega % p:x}_{p:x}"
    path = os.path.join(data_cache_dir("mxu_ntt"),
                        hashlib.sha256(tag.encode()).hexdigest()[:24] + ".npz")
    if os.path.exists(path):
        with np.load(path) as z:
            return z["mat"], z["rowsum"]

    w_pows = np.empty(m, dtype=object)   # omega^j
    cur = 1
    for j in range(m):
        w_pows[j] = cur
        cur = cur * omega % p
    mat = np.empty((NDIG * m, m * NDIG), dtype=np.int8)
    row = np.ones(m, dtype=object)       # W[i, :] for current i
    buf = np.empty((m, NDIG, NDIG), dtype=np.uint8)  # [j, b, s] digits
    for i in range(m):
        v = row.copy()                   # = W[i,:] * 2^{8b}, b ascending
        for b in range(NDIG):
            for j in range(m):
                buf[j, b] = np.frombuffer(
                    int(v[j]).to_bytes(NDIG, "little"), dtype=np.uint8)
            if b < NDIG - 1:
                v = (v << 8) % p
        # mat[(s, i), (j, b)] = buf[j, b, s] - 128
        mat[i::m, :] = (buf.transpose(2, 0, 1).reshape(NDIG, m * NDIG)
                        .astype(np.int16) - 128).astype(np.int8)
        row = row * w_pows % p
    rowsum = mat.astype(np.int32).sum(axis=1)
    np.savez(path, mat=mat, rowsum=rowsum)
    return mat, rowsum


@functools.partial(jax.jit, static_argnums=(2,))
def _digit_matrix_build_jit(wm_row, c256r, p_name: str):
    """Build the (32m, 32m) int8 digit matrix ON DEVICE from the (16, m)
    Montgomery-form first-power row [w^j * R]_j.

    W[i, j] = w^{ij} is generated standard-form by a scan of mont_muls
    (std * mont stays std); the 32 byte positions come from 32 successive
    mod-p byte shifts (mont_mul by [256R]).  The host build of the m=512
    matrix is ~20 s of bigint work plus a 268 MB transfer; this ships 32 KB
    and builds in device memory."""
    ctx = FR if p_name == "Fr" else D.FQ
    m = wm_row.shape[1]
    one = jnp.zeros((NLIMB, m), dtype=D.U32).at[0, :].set(1)

    def row_step(row, _):
        return D.mont_mul(row, wm_row, ctx), row

    _, W = jax.lax.scan(row_step, one, None, length=m)      # (m_i, 16, m_j)
    V = jnp.transpose(W, (1, 0, 2))                         # (16, i, j) std

    def byte_step(v, _):
        lo = (v & 0xFF).astype(jnp.uint8)
        hi = ((v >> 8) & 0xFF).astype(jnp.uint8)
        planes = jnp.stack([lo, hi], axis=1).reshape(NDIG, m, m)  # s = 2t+h
        return D.mont_mul(v, c256r, ctx), planes

    _, B = jax.lax.scan(byte_step, V, None, length=NDIG)    # (b, s, i, j)
    mat = (jnp.transpose(B, (1, 2, 3, 0)).astype(jnp.int16) - 128) \
        .astype(jnp.int8).reshape(NDIG * m, m * NDIG)
    rowsum = jnp.sum(mat.astype(jnp.int32), axis=1)
    return mat, rowsum


def _dft_digit_matrix_dev(m: int, omega: int, ctx):
    """Device-built digit matrix, bit-identical to _dft_digit_matrix_np."""
    p = ctx.p
    w_pows = [1] * m
    for j in range(1, m):
        w_pows[j] = w_pows[j - 1] * omega % p
    wm_row = jnp.asarray(D.np_pack(w_pows, ctx, mont=True))        # w^j * R
    c256r = jnp.asarray(
        D.np_pack([256 * ctx.r % p], ctx, mont=False)).reshape(NLIMB, 1, 1)
    return _digit_matrix_build_jit(wm_row, c256r, ctx.name)


@functools.lru_cache(maxsize=16)
def _dft_digit_matrix(m: int, omega: int, p_name: str):
    ctx = FR if p_name == "Fr" else D.FQ
    if m >= 64 and jax.default_backend() != "cpu":
        return _dft_digit_matrix_dev(m, omega % ctx.p, ctx)
    mat, rowsum = _dft_digit_matrix_np(m, omega % ctx.p, ctx.p)
    return jnp.asarray(mat), jnp.asarray(rowsum)


@functools.partial(jax.jit, static_argnums=(1,))
def _twiddle_build_jit(wm_row, m2: int):
    """(16, m1) Montgomery row [w^{t1} R] -> (16, m2, m1) Montgomery tensor
    T[k2, t1] = w^{k2*t1} R by a scan of mont_muls (device-resident; avoids
    the host bigint build and transfer of the 16 MB k=18 tensor)."""
    m1 = wm_row.shape[1]
    one = jnp.broadcast_to(
        jnp.asarray(FR.r_limbs, dtype=D.U32)[:, None], (NLIMB, m1))

    def step(row, _):
        return D.mont_mul(row, wm_row, FR), row

    _, T = jax.lax.scan(step, one, None, length=m2)   # (m2, 16, m1)
    return jnp.transpose(T, (1, 0, 2))


def _twiddle_tensor_dev(omega: int, m2: int, m1: int, ctx):
    p = ctx.p
    w_pows = [1] * m1
    for j in range(1, m1):
        w_pows[j] = w_pows[j - 1] * omega % p
    return _twiddle_build_jit(jnp.asarray(D.np_pack(w_pows, ctx)), m2)


@functools.lru_cache(maxsize=32)
def _twiddle_tensor(omega: int, m2: int, m1: int, p_name: str):
    """(16, m2, m1) Montgomery-form T[k2, t1] = omega^{k2*t1}."""
    ctx = FR if p_name == "Fr" else D.FQ
    if m2 * m1 >= (1 << 16) and ctx.name == "Fr" and \
            jax.default_backend() != "cpu":
        return _twiddle_tensor_dev(omega % ctx.p, m2, m1, ctx)
    p = ctx.p
    w_t1 = np.empty(m1, dtype=object)
    cur = 1
    for j in range(m1):
        w_t1[j] = cur
        cur = cur * (omega % p) % p
    rows = np.empty((m2, m1), dtype=object)
    row = np.ones(m1, dtype=object)
    for k2 in range(m2):
        rows[k2] = row
        row = row * w_t1 % p
    packed = D.np_pack([int(x) for x in rows.reshape(-1)], ctx)
    return jnp.asarray(packed.reshape(NLIMB, m2, m1))


@functools.lru_cache(maxsize=64)
def get_plan(n: int, omega: int, p_name: str = "Fr",
             max_m: int = MAX_MATMUL):
    """Build (and cache) the device-array plan for a size-n NTT at omega.
    Returns (NttPlan, res_omega) — res_omega non-None when the residual
    level runs as butterflies instead of a digit matmul."""
    ctx = FR if p_name == "Fr" else D.FQ
    omega %= ctx.p
    twiddles: List[jnp.ndarray] = []
    m, w = n, omega
    base = None
    while m > max_m:
        m2 = max_m
        m1 = m // m2
        if base is None:
            base = _dft_digit_matrix(m2, pow(w, m1, ctx.p), ctx.name)
        twiddles.append(_twiddle_tensor(w, m2, m1, ctx.name))
        m, w = m1, pow(w, m2, ctx.p)
    if m <= 8 and twiddles:
        # tiny residual: butterflies, no matrix needed (placeholder = base);
        # the residual omega travels OUTSIDE the plan pytree (it must stay a
        # static Python int for the host-side twiddle pow in _dft_small)
        res = base
        return NttPlan(base_mat=base[0], base_rowsum=base[1],
                       res_mat=res[0], res_rowsum=res[1],
                       twiddles=tuple(twiddles)), w
    res = _dft_digit_matrix(m, w, ctx.name)
    if base is None:
        base = res
    return NttPlan(base_mat=base[0], base_rowsum=base[1],
                   res_mat=res[0], res_rowsum=res[1],
                   twiddles=tuple(twiddles)), None


@functools.lru_cache(maxsize=8)
def _fold_consts(p_name: str):
    """Fold constants as numpy limb arrays:
    byte-position constants 2^{8q} mod p for q = 32, 33, 34, plus
    R = 2^256 mod p (for excess-limb folding)."""
    ctx = FR if p_name == "Fr" else D.FQ
    bytes_k = []
    for q in (32, 33, 34):
        v = (1 << (8 * q)) % ctx.p
        bytes_k.append(np.array(
            [(v >> (LIMB_BITS * j)) & MASK for j in range(NLIMB)], dtype=np.uint32))
    r = np.array([(ctx.r >> (LIMB_BITS * j)) & MASK for j in range(NLIMB)],
                 dtype=np.uint32)
    return np.stack(bytes_k), r


# ------------------------------ device kernels -------------------------------

def _to_digit_cols(a: jnp.ndarray) -> jnp.ndarray:
    """(16, m, B) uint32 limbs -> (m*32, B) int8 digit columns, offset -128."""
    m, B = a.shape[1], a.shape[2]
    lo = a & 0xFF
    hi = (a >> 8) & 0xFF
    dig = jnp.stack([lo, hi], axis=1).reshape(NDIG, m, B)   # digit index 2l+h
    dig = jnp.transpose(dig, (1, 0, 2)).reshape(m * NDIG, B)
    return (dig.astype(jnp.int32) - 128).astype(jnp.int8)


def _sweep(cols):
    """Carry-propagate a 16-column list; returns (canonical limbs, excess)."""
    out = []
    carry = jnp.zeros_like(cols[0])
    for j in range(NLIMB):
        v = cols[j] + carry
        out.append(v & MASK)
        carry = v >> LIMB_BITS
    return out, carry


def _planes_to_limbs(O: jnp.ndarray, ctx) -> jnp.ndarray:
    """(32, m, B) nonneg int32 digit planes -> (16, m, B) uint32 limbs.

    Result is the exact value mod p in a relaxed representation: 16 canonical
    16-bit limbs, value < 2^256 (possibly >= p).  Callers needing canonical
    form multiply by Montgomery-one (_canonicalize).

    Overflow discipline (all arithmetic in uint32):
      byte columns C_q < 4*255; limb columns < 2^19; every multiplier in a
      fold is < 2^16 so 16x16-bit products are exact; the 2^256-excess after
      each sweep shrinks ~2^4x per fold round because R = 2^256 mod p has a
      small top limb (~2^12), and the last two rounds handle excess <= 1
      exactly (adding R < 2^252 to a value < 2^256 can carry at most once,
      and after a carry the residual is < R, so one further round ends with
      zero excess)."""
    Ou = O.astype(U32)
    m, B = O.shape[1], O.shape[2]
    # byte-split: contributions to byte position q = plane + u
    C = jnp.zeros((NDIG + 4, m, B), dtype=U32)
    for u in range(4):
        C = C.at[u:u + NDIG].add((Ou >> (8 * u)) & 0xFF)
    # 16-bit limb columns from byte pairs (q < 32 only)
    cols = [C[2 * t] + (C[2 * t + 1] << 8) for t in range(NLIMB)]  # < 2^18
    # fold high byte positions q = 32, 33, 34 (values < 2^10: products exact)
    Kq, Kr = _fold_consts(ctx.name)
    excess = jnp.zeros_like(cols[0])
    for qi in range(3):
        h = C[NDIG + qi]
        for j in range(NLIMB):
            prod = h * np.uint32(int(Kq[qi, j]))
            cols[j] = cols[j] + (prod & MASK)
            if j + 1 < NLIMB:
                cols[j + 1] = cols[j + 1] + (prod >> LIMB_BITS)
            else:
                excess = excess + (prod >> LIMB_BITS)
    limbs, carry = _sweep(cols)
    excess = excess + carry                    # < ~2^13
    # fold rounds: excess*2^256 == excess*R (mod p); excess < 2^16 throughout
    for _ in range(5):
        cols = list(limbs)
        for j in range(NLIMB):
            prod = excess * np.uint32(int(Kr[j]))
            cols[j] = cols[j] + (prod & MASK)
            if j + 1 < NLIMB:
                cols[j + 1] = cols[j + 1] + (prod >> LIMB_BITS)
            else:
                nxt = prod >> LIMB_BITS
        limbs, carry = _sweep(cols)
        excess = nxt + carry
    return jnp.stack(limbs).astype(U32)


def _canonicalize(a: jnp.ndarray, ctx) -> jnp.ndarray:
    """Relaxed (< 2^256) -> canonical (< p), preserving Montgomery form:
    mont_mul by R (Montgomery one) = a mod p."""
    r = jnp.asarray(ctx.r_limbs, dtype=U32).reshape((NLIMB,) + (1,) * (a.ndim - 1))
    return D.mont_mul(a, r, ctx)


def _dft_planes(a: jnp.ndarray, mat: jnp.ndarray, rowsum: jnp.ndarray):
    """The int8 matmul core: (16, m, B) limbs -> (32, m, B) nonneg digit
    planes (offset corrections applied)."""
    m, B = a.shape[1], a.shape[2]
    XB = _to_digit_cols(a)                           # (32m, B) int8
    S_x = jnp.sum(XB.astype(jnp.int32), axis=0)      # (B,)
    MM = jax.lax.dot_general(mat, XB, (((1,), (0,)), ((), ())),
                             preferred_element_type=jnp.int32)
    K = m * NDIG
    O = MM + 128 * rowsum[:, None] + 128 * S_x[None, :] + 128 * 128 * K
    return O.reshape(NDIG, m, B)


def _dft_matmul(a: jnp.ndarray, mat: jnp.ndarray, rowsum: jnp.ndarray,
                ctx) -> jnp.ndarray:
    """Single-matmul DFT over axis 1 of (16, m, B); output relaxed limbs."""
    return _planes_to_limbs(_dft_planes(a, mat, rowsum), ctx)


def _dft_small(a: jnp.ndarray, omega: int, ctx) -> jnp.ndarray:
    """Tiny-m DFT (m <= 8) as radix-2 butterflies along axis 1 — cheaper
    than a digit-matmul pass for the residual level of big sizes (the k=20
    plan ends at m=4, where digit conversion dominated a matmul).  Inputs
    must be canonical (< p); they are, coming from the twiddle mont_mul."""
    m, B = a.shape[1], a.shape[2]
    k = m.bit_length() - 1
    # bit-reverse along axis 1 (m tiny: host-computed permutation)
    perm = [int(f"{i:0{k}b}"[::-1], 2) if k else 0 for i in range(m)]
    a = a[:, jnp.asarray(perm, dtype=jnp.int32), :]
    for s in range(k):
        half = 1 << s
        blocks = m >> (s + 1)
        v = a.reshape(NLIMB, blocks, 2, half, B)
        top = v[:, :, 0]
        bot = v[:, :, 1]
        tw_exps = [(j * (m >> (s + 1))) % m for j in range(half)]
        tws = D.pack([pow(omega, e, ctx.p) for e in tw_exps], ctx)  # (16, half)
        t = D.mont_mul(bot, tws[:, None, :, None], ctx)
        a = jnp.stack([D.add(top, t, ctx), D.sub(top, t, ctx)], axis=2) \
            .reshape(NLIMB, m, B)
    return a


def _dft_axis1(a: jnp.ndarray, plan: NttPlan, level: int, ctx,
               max_m: int, res_omega=None, scale=None) -> jnp.ndarray:
    """DFT over axis 1 (size m) of a (16, m, B) limb array.
    level indexes plan.twiddles; the last level uses the residual matrix
    (or butterflies when res_omega is given and m is tiny).

    scale: optional (16, 1) Montgomery scalar consumed at the residual
    level.  With scale given the output is CANONICAL (= mont_mul(relaxed,
    scale)); without it the output is relaxed (< 2^256)."""
    m, B = a.shape[1], a.shape[2]
    if level == len(plan.twiddles):
        if res_omega is not None:
            out = _dft_small(a, res_omega, ctx)
        else:
            out = _dft_matmul(a, plan.res_mat, plan.res_rowsum, ctx)
        if scale is not None:
            out = D.mont_mul(out, scale.reshape(NLIMB, 1, 1), ctx)
        return out
    m2 = max_m
    m1 = m // m2
    # t = t1 + m1*t2  ->  axes [t2, t1]
    a = a.reshape(NLIMB, m2, m1 * B)
    tw = plan.twiddles[level]                                 # (16, m2, m1)
    f = _dft_matmul(a, plan.base_mat, plan.base_rowsum, ctx)  # [k2, t1]
    f = f.reshape(NLIMB, m2, m1, B)
    f = D.mont_mul(f, tw[..., None], ctx)                     # canonical < p
    f = jnp.transpose(f, (0, 2, 1, 3)).reshape(NLIMB, m1, m2 * B)
    g = _dft_axis1(f, plan, level + 1, ctx, max_m, res_omega,
                   scale)                                      # [k1, (k2, B)]
    return g.reshape(NLIMB, m1 * m2, B)                       # k = k1*m2 + k2


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def _mxu_ntt_jit(a: jnp.ndarray, plan: NttPlan, max_m: int,
                 p_name: str, res_omega) -> jnp.ndarray:
    ctx = FR if p_name == "Fr" else D.FQ
    n = a.shape[1]
    one = jnp.asarray(ctx.r_limbs, dtype=D.U32).reshape(NLIMB, 1)
    out = _dft_axis1(a.reshape(NLIMB, n, 1), plan, 0, ctx, max_m, res_omega,
                     scale=one)
    return out.reshape(NLIMB, n)


def mxu_ntt(a: jnp.ndarray, omega: int, k: int, max_m: Optional[int] = None,
            ctx=FR) -> jnp.ndarray:
    """Forward NTT of a (16, n) Montgomery-limb array: coeffs -> evals in
    natural order (same contract as ops/ntt.ntt)."""
    max_m = max_m or auto_max_m(1 << k)
    plan, res_omega = get_plan(1 << k, omega % ctx.p, ctx.name, max_m)
    return _mxu_ntt_jit(a, plan, max_m, ctx.name, res_omega)


@functools.partial(jax.jit, static_argnums=(2, 3, 4, 5))
def _mxu_intt_jit(a, plan, max_m, p_name, res_omega, divisor_inv):
    ctx = FR if p_name == "Fr" else D.FQ
    n = a.shape[1]
    # mont_mul(relaxed, d) both reduces mod p AND applies 1/n in one pass —
    # identical to canonicalize-then-scale (x·R·R⁻¹·d·R⁻¹ == x·d·R⁻¹).
    d = D.pack_scalar(divisor_inv, ctx).reshape(NLIMB, 1)
    out = _dft_axis1(a.reshape(NLIMB, n, 1), plan, 0, ctx, max_m, res_omega,
                     scale=d)
    return out.reshape(NLIMB, n)


def mxu_intt(a: jnp.ndarray, omega_inv: int, k: int, divisor_inv: int,
             max_m: Optional[int] = None, ctx=FR) -> jnp.ndarray:
    """Inverse NTT: evals -> coeffs scaled by divisor_inv (= 1/n)."""
    max_m = max_m or auto_max_m(1 << k)
    plan, res_omega = get_plan(1 << k, omega_inv % ctx.p, ctx.name, max_m)
    return _mxu_intt_jit(a, plan, max_m, ctx.name, res_omega,
                         divisor_inv % ctx.p)


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def _mxu_batch_scaled_jit(a, plan, res_omega, p_name, divisor_inv):
    ctx = FR if p_name == "Fr" else D.FQ
    d = D.pack_scalar(divisor_inv, ctx).reshape(NLIMB, 1)
    return mxu_ntt_batch(a, plan, res_omega, ctx, scale=d)


def mxu_lagrange_to_coeff_batch(a: jnp.ndarray, omega_inv: int, k: int,
                                divisor_inv: int, ctx=FR) -> jnp.ndarray:
    """(16, C, n) Lagrange -> coefficient batch by matmul iNTT (+ 1/n)."""
    plan, res_omega = get_plan(1 << k, omega_inv % ctx.p, ctx.name)
    return _mxu_batch_scaled_jit(a, plan, res_omega, ctx.name, divisor_inv)


def mxu_ntt_batch(a: jnp.ndarray, plan: NttPlan, res_omega, ctx=FR,
                  max_m: int = MAX_MATMUL, chunk: int = 16,
                  scale=None) -> jnp.ndarray:
    """Batched forward NTT over the LAST axis of a (16, C, n) limb array.

    Trace-safe inside an enclosing jit (the plan travels as a pytree of
    device arrays — callers obtain it from get_plan and pass it through
    their own jit boundary as an argument).  The column axis rides the
    matmul B dimension, so all C transforms share each digit-matrix
    dispatch; columns are processed in `chunk`-sized groups to bound the
    int32 digit-plane working set (32 * m * m1 * chunk * 4 bytes)."""
    C, n = a.shape[1], a.shape[2]
    if C == 0:
        return a
    if scale is None:
        scale = jnp.asarray(ctx.r_limbs, dtype=D.U32).reshape(NLIMB, 1)
    outs = []
    for lo in range(0, C, chunk):
        blk = a[:, lo:lo + chunk]
        cb = blk.shape[1]
        at = jnp.transpose(blk, (0, 2, 1))              # (16, n, cb)
        f = _dft_axis1(at, plan, 0, ctx, max_m, res_omega, scale=scale)
        outs.append(jnp.transpose(f, (0, 2, 1)))
    return jnp.concatenate(outs, axis=1) if len(outs) > 1 else outs[0]

def mxu_ntt_batch_mapped(a: jnp.ndarray, plan: NttPlan, res_omega, ctx=FR,
                         max_m: int = MAX_MATMUL, chunk: int = 64,
                         scale=None, out_dtype=None, pre_mult=None,
                         pad_to: int = 0) -> jnp.ndarray:
    """mxu_ntt_batch with `lax.map` column chunking: ONE traced NTT pipeline
    regardless of C.

    The python-loop variant above unrolls a full digit-matmul pipeline per
    16-column chunk, so a 220-column SHA-256 convert graph repeats the
    ~10^4-node pipeline 14x.  The single-device prover fuses its whole h
    path into one program (plonk/device_eval h_all_fn); this variant keeps
    that program's size, and its compile time, independent of the
    circuit's column count.
    Zero-padded columns transform to zeros and are sliced off, so values
    are bit-identical to mxu_ntt_batch.  Per-chunk scratch: the level-0
    int32 matmul output is 32 * m * chunk * 4 bytes (134 MB at m=16384,
    chunk=64)."""
    C, n = a.shape[1], a.shape[2]
    if C == 0:
        return a
    if scale is None:
        scale = jnp.asarray(ctx.r_limbs, dtype=D.U32).reshape(NLIMB, 1)

    def body(blk):                                     # (16, chunk, n)
        # the full widen / pre-multiply / zero-pad pipeline runs PER CHUNK:
        # a whole-stack mont_mul holds ~33 deferred-carry column temps of
        # the full batch (432 MB each at 212 cols x n=32768); per chunk the
        # working set is chunk/C of that
        x = blk.astype(U32)
        if pre_mult is not None:
            x = D.mont_mul(x, pre_mult[:, None, :], ctx)
        if pad_to and pad_to > n:
            x = jnp.concatenate(
                [x, jnp.zeros((NLIMB, x.shape[1], pad_to - n), dtype=U32)],
                axis=2)
        at = jnp.transpose(x, (0, 2, 1))
        f = _dft_axis1(at, plan, 0, ctx, max_m, res_omega, scale=scale)
        out = jnp.transpose(f, (0, 2, 1))
        # out_dtype=uint16 narrows per chunk (canonical limbs < 2^16), so
        # the full u32 result never materializes — callers that hold big
        # extended-domain state use this to halve its device footprint
        return out.astype(out_dtype) if out_dtype is not None else out

    if C <= chunk:
        return body(a)
    pad = (-C) % chunk
    if pad:
        a = jnp.concatenate(
            [a, jnp.zeros((NLIMB, pad, n), dtype=a.dtype)], axis=1)
    nc = (C + pad) // chunk
    at = jnp.moveaxis(a.reshape(NLIMB, nc, chunk, n), 1, 0)
    out = jax.lax.map(body, at)                  # (nc, 16, chunk, n_out)
    n_out = out.shape[3]
    return jnp.moveaxis(out, 0, 1).reshape(NLIMB, nc * chunk, n_out)[:, :C]
