"""Multi-scalar multiplication (Pippenger): native host kernel and a device
window-sum kernel.

The reference `best_multiexp` (halo2_proofs/src/arithmetic.rs:13-159) is a
per-thread serial Pippenger with scatter-into-buckets.  The device redesign
is branch-free and sort-based:

  window digits (c = 16, one per scalar limb)
    -> per window (sequential lax.map, so one compiled body):
       sort point indices by digit            (XLA sort, lane-parallel)
       segmented inclusive scan of points     (Hillis-Steele over log2 n
                                               steps of the unified Jacobian
                                               add — branch-free combiner)
       segment tails scattered into 2^c buckets
       suffix-sum of buckets + log-shift total = window sum
    -> 2^{16w}-weighted window fold on host (16 tiny point ops)

All group math is the branch-free Jacobian arithmetic in curves/device.py;
identity = Z=0 lanes makes every mask a select.  Multi-chip: shard the point
axis, psum the (tiny) per-window bucket sums — see parallel/.
"""
from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..curves import device as PD
from ..curves import host as CH
from ..fields import device as D
from ..fields import host as H
from ..fields.device import FQ, NLIMB, U32

# Below this size msm() uses the host (native C / OpenMP) Pippenger.  The
# split was set on an earlier accelerator that lacked a native 32-bit
# integer multiply; Pippenger is integer-multiply bound and has no matmul
# shape, so commitments ran on the native host layer and the device carried
# the matmul-shaped work (basis conversions, h evaluation).  The H100
# multiplies integers natively, so the threshold is open for re-measurement
# (ROADMAP speed item 2); msm_device is checked against the native
# Pippenger on the card by chip_smoke.py.
HOST_THRESHOLD = 1 << 20


def pick_window_bits(n: int) -> int:
    """Window size balancing the O(n log n) segmented scan against the
    O(2^c) bucket scans per window (both are unified-add lanes)."""
    c = max(4, min(16, (n.bit_length() - 1)))
    # keep bucket work (2*2^c) under ~2x scan work (n log n)
    while c > 4 and (1 << c) > n * max(1, n.bit_length()):
        c -= 1
    return c


def _scalars_to_digits(scalars: Sequence[int], c: int) -> np.ndarray:
    """(ceil(256/c), n) uint32 c-bit windows of each scalar."""
    n = len(scalars)
    nw = (256 + c - 1) // c
    out = np.zeros((nw, n), dtype=np.uint32)
    mask = (1 << c) - 1
    for i, s in enumerate(scalars):
        s %= H.FR_MOD
        for w in range(nw):
            out[w, i] = (s >> (c * w)) & mask
    return out


def _ceil_log2(n: int) -> int:
    return max(1, (n - 1).bit_length())


@functools.partial(jax.jit, static_argnums=(2, 3))
def _window_sums(points, digits, n: int, c: int = 16):
    """points: (X, Y, Z) each (16, n); digits: (nw, n) uint32 c-bit windows.
    Returns (nw, 3, 16) window sums."""
    X, Y, Z = points
    log_n = _ceil_log2(n)

    def one_window(d):
        order = jnp.argsort(d)
        ds = jnp.take(d, order)
        pt = (jnp.take(X, order, axis=1), jnp.take(Y, order, axis=1), jnp.take(Z, order, axis=1))
        # zero-digit lanes contribute nothing: mask them to identity
        live = ds != 0
        pt = PD.select_point(live, pt, PD.identity_like((n,)))

        # segmented inclusive scan (Hillis-Steele): acc[i] = sum of points
        # j <= i in i's digit-segment
        idx = jnp.arange(n, dtype=jnp.int32)

        def step(t, carry):
            acc, seg = carry
            offset = jnp.int32(1) << t
            sh = tuple(jnp.roll(a, offset, axis=1) for a in acc)
            sh_seg = jnp.roll(seg, offset)
            combined = PD.point_add(sh, acc)
            use = (idx >= offset) & (sh_seg == seg)
            acc = PD.select_point(use, combined, acc)
            return (acc, seg)

        acc, _ = jax.lax.fori_loop(0, log_n, step, (pt, ds))

        # segment tails -> buckets
        nxt = jnp.roll(ds, -1)
        is_tail = (idx == n - 1) | (ds != nxt)
        # scatter segment tails into buckets; non-tail lanes are routed to
        # bucket 0 (discarded below) with a zero payload, so collisions there
        # are all-equal writes
        tgt = jnp.where(is_tail, ds.astype(jnp.int32), jnp.int32(0))
        zero = jnp.zeros_like(acc[0])
        bX = D.zeros((1 << c,), FQ).at[:, tgt].set(jnp.where(is_tail[None, :], acc[0], zero))
        bY = D.zeros((1 << c,), FQ).at[:, tgt].set(jnp.where(is_tail[None, :], acc[1], zero))
        bZ = D.zeros((1 << c,), FQ).at[:, tgt].set(jnp.where(is_tail[None, :], acc[2], zero))
        # bucket 0 is skipped entirely
        ident = PD.identity_like((1 << c,))
        bucket0 = jnp.arange(1 << c) == 0
        B = PD.select_point(bucket0 | D.is_zero(bZ), ident, (bX, bY, bZ))

        # suffix sums R_j = sum_{b >= j} B_b (reverse Hillis-Steele scan);
        # ONE loop body shared by both scan passes — each fori_loop body is a
        # separate XLA compile of a point_add (~25k HLO with the register-form
        # mont_mul), so duplicating the identical body doubled compile cost
        m = 1 << c
        bidx = jnp.arange(m, dtype=jnp.int32)

        def sstep(t, acc):
            offset = jnp.int32(1) << t
            sh = tuple(jnp.roll(a, -offset, axis=1) for a in acc)
            combined = PD.point_add(sh, acc)
            use = bidx < (m - offset)
            return PD.select_point(use, combined, acc)

        R = jax.lax.fori_loop(0, c, sstep, B)
        # window sum = sum_{j>=1} R_j ; zero out R_0 then total-sum by shifts
        R = PD.select_point(bidx == 0, PD.identity_like((m,)), R)
        T = jax.lax.fori_loop(0, c, sstep, R)
        return jnp.stack([T[0][:, 0], T[1][:, 0], T[2][:, 0]])  # (3, 16)

    return jax.lax.map(one_window, digits)


def _neg_y(pt):
    """Jacobian negation (free) for bucket boundary subtraction: sum over a
    segment = S[tail] - S[head-1].  Delegates to the curve layer."""
    return PD.point_neg(pt)


def pick_window_bits_v2(n: int) -> int:
    """Window size for the block-scan kernel: balance the O(n) prefix scan
    against the O((2c+3)*2^c) bucket-side work per window."""
    c = 8
    while c < 16 and (1 << (c + 1)) * (2 * (c + 1) + 3) <= n:
        c += 1
    return c


@functools.partial(jax.jit, static_argnums=(2, 3, 4))
def _window_sums_v2(points, digits, n: int, c: int, block: int = 256):
    """Block-scan window sums: ~2n lane point-adds per window instead of the
    Hillis-Steele kernel's n*log2(n).

    Per window:
      sort by digit; exclusive prefix scan of the sorted points in three
      fixed-shape phases (block-local sequential scan, Hillis-Steele over
      the n/block block totals, nothing full-width); every bucket's sum is
      then S[tail] - S[head-1] = E[next_head] + (-E[head]) — EC negation is
      free — gathered and combined on 2^c lanes only; suffix scans turn
      buckets into the weighted window sum as before.

    All phases are fori_loops with level-independent shapes, so the body
    (one unified Jacobian add, ~25k HLO) compiles a constant number of
    times.  n must be a multiple of `block`."""
    X, Y, Z = points
    nb = n // block
    m = 1 << c

    def one_window(d):
        order = jnp.argsort(d)
        ds = jnp.take(d, order)
        pt = (jnp.take(X, order, axis=1), jnp.take(Y, order, axis=1),
              jnp.take(Z, order, axis=1))
        live = ds != 0
        pt = PD.select_point(live, pt, PD.identity_like((n,)))

        # ---- phase 1: block-local EXCLUSIVE scan (sequential over block,
        # vectorized over the n/block blocks; lane-adds = n) ----------------
        a = tuple(p.reshape(NLIMB, nb, block) for p in pt)
        E0 = PD.identity_like((nb, block))

        def p1(j, carry):
            acc, E = carry
            col = tuple(jax.lax.dynamic_slice_in_dim(p, j, 1, axis=2)[:, :, 0]
                        for p in a)
            E = tuple(jax.lax.dynamic_update_slice_in_dim(
                e, acc_c[:, :, None], j, axis=2)
                for e, acc_c in zip(E, acc))
            return (PD.point_add(acc, col), E)

        btot, E_loc = jax.lax.fori_loop(0, block, p1, (PD.identity_like((nb,)), E0))

        # ---- phase 2: exclusive Hillis-Steele over the nb block totals ----
        bidx2 = jnp.arange(nb, dtype=jnp.int32)

        def p2(t, acc):
            off = jnp.int32(1) << t
            sh = tuple(jnp.roll(p, off, axis=1) for p in acc)
            comb = PD.point_add(sh, acc)
            return PD.select_point(bidx2 >= off, comb, acc)

        incl = jax.lax.fori_loop(0, _ceil_log2(nb), p2, btot)
        T_all = tuple(p[:, nb - 1] for p in incl)                # scan total
        bpref = PD.select_point(bidx2 == 0, PD.identity_like((nb,)),
                                tuple(jnp.roll(p, 1, axis=1) for p in incl))

        # ---- bucket sums from E at head lanes only -------------------------
        idx = jnp.arange(n, dtype=jnp.int32)
        is_head = (idx == 0) | (ds != jnp.roll(ds, 1))
        hb = jnp.where(is_head, ds.astype(jnp.int32), jnp.int32(0))
        headpos = jnp.full((m,), -1, jnp.int32).at[hb].set(
            jnp.where(is_head, idx, jnp.int32(-1)))
        # tail-E position of bucket b = head position of the NEXT segment
        prev_b = jnp.roll(ds, 1).astype(jnp.int32)
        tailpos = jnp.full((m,), -1, jnp.int32).at[
            jnp.where(is_head & (idx > 0), prev_b, jnp.int32(0))].set(
            jnp.where(is_head & (idx > 0), idx, jnp.int32(-1)))
        tailpos = tailpos.at[ds[n - 1].astype(jnp.int32)].set(jnp.int32(n))

        E_flat = tuple(p.reshape(NLIMB, n) for p in E_loc)

        def gather_E(pos):
            """E[pos] = block_prefix[pos//block] + E_local[pos], identity for
            pos < 0, T_all for pos == n; one 2^c-lane point_add."""
            safe = jnp.clip(pos, 0, n - 1)
            el = tuple(p[:, safe] for p in E_flat)
            bp = tuple(p[:, safe // block] for p in bpref)
            e = PD.point_add(el, bp)
            e = PD.select_point(pos == n,
                                tuple(jnp.broadcast_to(p[:, None], (NLIMB, m))
                                      for p in T_all), e)
            return PD.select_point(pos < 0, PD.identity_like((m,)), e)

        B = PD.point_add(gather_E(tailpos), _neg_y(gather_E(headpos)))
        bucket0 = jnp.arange(m) == 0
        B = PD.select_point(bucket0 | D.is_zero(B[2]), PD.identity_like((m,)), B)

        # ---- suffix sums + weighted total (same two scans as before) ------
        bidx = jnp.arange(m, dtype=jnp.int32)

        def sstep(t, acc):
            offset = jnp.int32(1) << t
            sh = tuple(jnp.roll(p, -offset, axis=1) for p in acc)
            combined = PD.point_add(sh, acc)
            return PD.select_point(bidx < (m - offset), combined, acc)

        R = jax.lax.fori_loop(0, c, sstep, B)
        R = PD.select_point(bidx == 0, PD.identity_like((m,)), R)
        T = jax.lax.fori_loop(0, c, sstep, R)
        return jnp.stack([T[0][:, 0], T[1][:, 0], T[2][:, 0]])  # (3, 16)

    return jax.lax.map(one_window, digits)


def msm_device(scalars: Sequence[int], points, digits: Optional[np.ndarray] = None,
               c: Optional[int] = None, kernel: str = "v2"):
    """Pippenger MSM on device; points = host affine list or device PointArray."""
    n = len(scalars) if digits is None else digits.shape[1]
    c = c or (pick_window_bits_v2(n) if kernel == "v2" else pick_window_bits(n))
    if digits is None:
        digits = _scalars_to_digits(scalars, c)
    nw = digits.shape[0]
    if not isinstance(points, tuple):
        points = PD.pack_affine(points)
    if kernel == "v2":
        block = min(256, max(2, 1 << (max(1, n.bit_length() - 1) // 2)))
        pad = (-n) % block
        if pad:
            digits = np.concatenate(
                [np.asarray(digits), np.zeros((nw, pad), np.uint32)], axis=1)
            points = tuple(jnp.concatenate(
                [p, jnp.zeros((NLIMB, pad), dtype=p.dtype)], axis=1)
                for p in points)
        sums = _window_sums_v2(points, jnp.asarray(digits), n + pad, c, block)
    else:
        sums = _window_sums(points, jnp.asarray(digits), n, c)
    return fold_window_sums(sums, c)


def fold_window_sums(sums, c: int) -> CH.G1Affine:
    """Host fold of per-window Jacobian sums S_w — (nw, 3, 16) Montgomery Fq
    limbs, window 0 least significant — into sum_w 2^{c*w} S_w (affine)."""
    sums = np.asarray(jax.device_get(sums))
    rinv = pow(FQ.r, FQ.p - 2, FQ.p)
    total = None
    for w in range(sums.shape[0] - 1, -1, -1):
        x, y, z = (sum(int(sums[w][j][i]) << (16 * i)
                       for i in range(NLIMB)) * rinv % FQ.p
                   for j in range(3))
        if total is not None:
            for _ in range(c):
                total = CH.g1_add(total, total)
        if z != 0:
            zi = H.inv_mod(z, FQ.p)
            zi2 = zi * zi % FQ.p
            total = CH.g1_add(total, (x * zi2 % FQ.p, y * zi2 * zi % FQ.p))
    return total


def msm_host(scalars: Sequence[int], points, packed=None) -> CH.G1Affine:
    """Host Pippenger (c=8): native C kernel when available, else the
    pure-Python Jacobian accumulation.

    packed: optional pre-marshalled basis buffer (native_loader
    .pack_points_affine) covering at least len(scalars) points — skips the
    per-call point marshalling for fixed commitment bases."""
    n = len(scalars)
    if n == 0:
        return None
    if packed is not None:
        from ..native_loader import native_msm_packed
        res = native_msm_packed([s % H.FR_MOD for s in scalars], packed, n)
        if res is not None:
            return CH.jac_to_affine(res)
    from ..native_loader import native_msm
    jac = [CH.jac_from_affine(pt) for pt in points[:n]]
    res = native_msm([s % H.FR_MOD for s in scalars], jac)
    if res is not None:
        return CH.jac_to_affine(res)
    c = 8 if n >= 32 else 4
    nw = (256 + c - 1) // c
    total = CH.JAC_IDENTITY
    for w in range(nw - 1, -1, -1):
        if total != CH.JAC_IDENTITY:
            for _ in range(c):
                total = CH.jac_double(total)
        buckets: dict = {}
        for s, pt in zip(scalars, points):
            if pt is None:
                continue
            d = ((s % H.FR_MOD) >> (c * w)) & ((1 << c) - 1)
            if d:
                if d in buckets:
                    buckets[d] = CH.jac_add_affine(buckets[d], pt)
                else:
                    buckets[d] = CH.jac_from_affine(pt)
        run = CH.JAC_IDENTITY
        acc = CH.JAC_IDENTITY
        for d in range(max(buckets) if buckets else 0, 0, -1):
            if d in buckets:
                run = CH.jac_add(run, buckets[d])
            acc = CH.jac_add(acc, run)
        total = CH.jac_add(total, acc)
    return CH.jac_to_affine(total)


def msm(scalars: Sequence[int], points, packed=None) -> CH.G1Affine:
    """Dispatch: MSMs below HOST_THRESHOLD on host, larger ones on the device."""
    if len(scalars) < HOST_THRESHOLD:
        return msm_host(scalars, points, packed=packed)
    return msm_device(scalars, points)


def packed_basis(obj, attr: str, points):
    """Lazily cache a pre-marshalled native basis buffer on `obj` (None when
    the native lib is unavailable).

    Big bases (>= 2^14 points) are also disk-cached as raw limb bytes:
    marshalling a 2^18-point Lagrange basis costs seconds of Python bigint
    `to_bytes` per fresh process (most of the cold-process cq_msms tax),
    while reading the 24 MB blob back is ~30 ms."""
    if attr not in obj.__dict__:
        from ..native_loader import pack_points_affine
        pts = points() if callable(points) else points
        packed = None
        if len(pts) >= DISK_BASIS_MIN and not any(p is None for p in pts):
            packed = _packed_basis_disk(pts)
        if packed is None:
            packed = pack_points_affine(pts)
        obj.__dict__[attr] = packed
    return obj.__dict__[attr]


DISK_BASIS_MIN = 1 << 14  # smallest basis worth a disk round trip


def _packed_basis_disk(points):
    """Disk-backed pack_points_affine: raw bytes keyed on (len, 3 sample
    points).  Returns None (caller falls back) on any I/O problem."""
    import ctypes
    import hashlib
    import os

    from ..native_loader import get_lib, pack_points_affine
    if get_lib() is None:
        return None
    n = len(points)
    sample = [points[(i * (n - 1)) // 15] for i in range(16)]
    key = hashlib.sha256(repr((n, sample)).encode()).hexdigest()[:20]
    from .. import data_cache_dir
    path = os.path.join(data_cache_dir(), f"packedbasis_{key}.bin")
    try:
        if os.path.exists(path):
            with open(path, "rb") as f:
                raw = f.read()
            if len(raw) == 96 * n:
                return (ctypes.c_uint64 * (12 * n)).from_buffer_copy(raw)
    except Exception:
        pass
    packed = pack_points_affine(points)
    if packed is not None:
        try:
            with open(path + ".tmp", "wb") as f:
                f.write(bytes(packed))
            os.replace(path + ".tmp", path)
        except Exception:
            pass
    return packed


def msm_multi(jobs) -> list:
    """Many independent MSMs in ONE native call (g1_msm_multi, OpenMP across
    jobs) — the prover's per-phase commitment batches.  jobs: list of
    (packed_basis, indices_or_None, scalars, fallback_points); falls back to
    the per-job host path when native is unavailable.  Returns G1Affine (or
    None for empty jobs) per job."""
    out: list = [None] * len(jobs)
    native = [(j, job) for j, job in enumerate(jobs)
              if len(job[2]) > 0 and job[0] is not None]
    rest = [(j, job) for j, job in enumerate(jobs)
            if len(job[2]) > 0 and job[0] is None]
    if native:
        from ..native_loader import native_msm_multi
        reduced = [(packed, indices,
                    scalars if isinstance(scalars, np.ndarray)
                    else [s % H.FR_MOD for s in scalars])
                   for _, (packed, indices, scalars, _pts) in native]
        res = native_msm_multi(reduced)
        if res is not None:
            for (j, _), jac in zip(native, res):
                out[j] = CH.jac_to_affine(jac)
        else:
            rest = native + rest
    for j, (packed, indices, scalars, pts) in rest:
        if isinstance(scalars, np.ndarray):
            from ..native_loader import fr_unbuf
            scalars = fr_unbuf(scalars)
        if indices is None:
            out[j] = msm_host(list(scalars), pts, packed=packed)
        else:
            out[j] = msm_indexed(scalars, indices, pts, packed=packed)
    return out


def msm_combined(jobs, gjobs) -> list:
    """Plain/indexed jobs + grouped jobs in ONE native OpenMP region
    (g1_msm_unified), so the grouped b0/p batch fills the tail-idle cores
    of the indexed batch instead of running strictly after it.  Returns
    results in jobs + gjobs order; per-job allocation failures (and an
    absent/old native lib) fall back to the split paths."""
    uni = [("p", p, i, s) for (p, i, s, _pts) in jobs] + \
          [("g", p, r, st, sc) for (p, r, st, sc) in gjobs]
    from ..native_loader import native_msm_unified
    res = native_msm_unified(uni)
    if res is not None and all(r is not None for r in res):
        return [CH.jac_to_affine(jac) for jac in res]
    out_p = msm_multi(jobs)
    out_g = msm_grouped_multi(gjobs) if gjobs else []
    return out_p + out_g


def msm_grouped_multi(jobs) -> list:
    """Many grouped sparse MSMs in ONE native call: per job
    (packed_basis, rows, starts, scalars) computes
    sum_g scalars[g] * (sum_{i in rows[starts[g]:starts[g+1]]} basis[rows[i]]).
    Native-only — callers gate on get_lib(); group sums are one mixed add
    per row, then Pippenger over the (much smaller) per-group sums."""
    from ..native_loader import native_msm_grouped_multi
    res = native_msm_grouped_multi(jobs)
    if res is None:
        raise RuntimeError("msm_grouped_multi requires the native library")
    return [CH.jac_to_affine(jac) for jac in res]


def msm_indexed(scalars: Sequence[int], indices: Sequence[int], points,
                packed=None) -> CH.G1Affine:
    """sum_i scalars[i] * points[indices[i]]; native indexed kernel over a
    packed basis when available, else gather + host path."""
    if packed is not None:
        from ..native_loader import native_msm_indexed
        res = native_msm_indexed([s % H.FR_MOD for s in scalars],
                                 list(indices), packed)
        if res is not None:
            return CH.jac_to_affine(res)
    return msm_host(list(scalars), [points[i] for i in indices])
