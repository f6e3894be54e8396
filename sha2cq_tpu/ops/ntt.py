"""Device radix-2 NTT over BN254 Fr.

Semantics match the reference's `best_fft` (halo2_proofs/src/arithmetic.rs:
171-274): bit-reversal permutation followed by log2(n) in-place butterfly
stages; with input interpreted as coefficients the output is evaluations at
the n powers of omega in natural order.  Inverse = same transform with
omega^{-1} plus a final scale by n^{-1} (domain.rs:366-374).

Device mapping: one bit-reversal gather, then k identical constant-geometry
stages (one Montgomery multiply, add/sub over the whole limb array) in one
loop.  Multi-device scaling shards the batch axis (see parallel/).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..fields import device as D
from ..fields.device import FR, NLIMB, U32


@functools.lru_cache(maxsize=32)
def _bitrev_perm(k: int) -> np.ndarray:
    n = 1 << k
    perm = np.zeros(n, dtype=np.int32)
    for i in range(n):
        r = 0
        x = i
        for _ in range(k):
            r = (r << 1) | (x & 1)
            x >>= 1
        perm[i] = r
    return perm


def powers_host(base: int, n: int, p: int) -> list:
    """[1, base, base^2, ...] as ints (host; used for twiddle tables)."""
    out = [1] * n
    for i in range(1, n):
        out[i] = out[i - 1] * base % p
    return out


@functools.lru_cache(maxsize=64)
def twiddle_table(omega: int, k: int, p_name: str = "Fr") -> jnp.ndarray:
    """(16, n//2) Montgomery-form table of omega^i, i < n/2.

    ensure_compile_time_eval: this cache may first fire inside a jit trace
    (e.g. the prover's fused h_fn); without it the cache would capture a
    tracer and poison later eager calls."""
    ctx = FR if p_name == "Fr" else D.FQ
    n = 1 << k
    vals = powers_host(omega % ctx.p, max(n // 2, 1), ctx.p)
    with jax.ensure_compile_time_eval():
        return jnp.asarray(D.np_pack(vals, ctx))


@functools.partial(jax.jit, static_argnums=(2,))
def ntt_last_axis(a: jnp.ndarray, twiddles: jnp.ndarray, k: int) -> jnp.ndarray:
    """Radix-2 DIT NTT along the last axis of a (16, ..., n) limb array.

    Constant-geometry form: after the single bit-reversal gather, every
    stage reads the pairs at (2j, 2j+1) and writes them to (j, j + n/2), so
    all k stages have one shape and run as ONE lax.fori_loop body.  (With
    the stages unrolled, XLA:GPU compiled a 2^13 transform for over three
    minutes.)  The data layout at stage s is the natural DIT order rotated
    right by s bits, so the pair at j takes the twiddle omega^e with
    e = j with its low k-1-s bits cleared; after k stages the rotation is
    the identity and the output is in natural order.
    """
    n = 1 << k
    a = jnp.take(a, jnp.asarray(_bitrev_perm(k)), axis=-1)
    if n == 1:
        return a
    lead = a.shape[:-1]
    j = jnp.arange(n // 2, dtype=jnp.int32)
    tw_shape = (NLIMB,) + (1,) * (a.ndim - 2) + (n // 2,)

    def stage(s, x):
        v = x.reshape(*lead, n // 2, 2)
        top, bot = v[..., 0], v[..., 1]
        low = jnp.int32(k - 1) - s
        tw = jnp.take(twiddles, (j >> low) << low, axis=1).reshape(tw_shape)
        t = D.mont_mul(bot, tw, FR)
        return jnp.concatenate([D.add(top, t, FR), D.sub(top, t, FR)], axis=-1)

    return jax.lax.fori_loop(0, k, stage, a)


def ntt(a: jnp.ndarray, omega: int, k: int) -> jnp.ndarray:
    """Forward NTT of a (16, n) Montgomery-limb array: coeffs -> evals."""
    return ntt_last_axis(a, twiddle_table(omega, k), k)


def intt(a: jnp.ndarray, omega_inv: int, k: int, divisor_inv: int) -> jnp.ndarray:
    """Inverse NTT: evals -> coeffs (scaled by 1/n, passed as divisor_inv)."""
    out = ntt_last_axis(a, twiddle_table(omega_inv, k), k)
    d = D.pack_scalar(divisor_inv, FR).reshape(NLIMB, 1)
    return D.mont_mul(out, d, FR)


# ----------------------------- host reference -------------------------------

@functools.lru_cache(maxsize=64)
def _host_twiddle_buf(omega: int, n: int, p: int):
    """(n/2, 4) uint64 buffer of [w^0 .. w^{n/2-1}] for the native NTT."""
    from ..native_loader import fr_buf
    tws = [0] * (n // 2)
    cur = 1
    for i in range(n // 2):
        tws[i] = cur
        cur = cur * omega % p
    return fr_buf(tws)


def ntt_host(values: list, omega: int, p: int) -> list:
    """Host radix-2 NTT: native C kernel (fieldops.c fr_ntt, OpenMP) for
    large Fr transforms, recursive Python oracle otherwise."""
    n = len(values)
    from ..fields.host import FR_MOD
    if n >= 256 and p == FR_MOD and (n & (n - 1)) == 0:
        from ..native_loader import native_fr_ntt
        out = native_fr_ntt([v % p for v in values],
                            _host_twiddle_buf(omega % p, n, p),
                            n.bit_length() - 1)
        if out is not None:
            return out
    return _ntt_host_py(values, omega, p)


def _ntt_host_py(values: list, omega: int, p: int) -> list:
    """O(n^2)-free host radix-2 NTT (recursive), oracle for tests."""
    n = len(values)
    if n == 1:
        return list(values)
    even = _ntt_host_py(values[0::2], omega * omega % p, p)
    odd = _ntt_host_py(values[1::2], omega * omega % p, p)
    out = [0] * n
    w = 1
    for i in range(n // 2):
        t = w * odd[i] % p
        out[i] = (even[i] + t) % p
        out[i + n // 2] = (even[i] - t) % p
        w = w * omega % p
    return out


def intt_host(values: list, omega: int, p: int) -> list:
    n = len(values)
    ninv = pow(n, p - 2, p)
    out = ntt_host(values, pow(omega, p - 2, p), p)
    return [x * ninv % p for x in out]
