"""Multi-chip distribution of the prover's bulk kernels.

The reference's entire parallel runtime is a rayon re-export
(halo2_proofs/src/multicore.rs:1-5).  The device equivalent (SURVEY.md
§2.4) distributes over a jax.sharding Mesh with XLA collectives (NCCL on
GPUs):

  - NTT: four-step decomposition n = R x C — local size-R NTTs on the
    sharded column axis, pointwise twiddles, an all_to_all "transpose" that
    re-shards, then local size-C NTTs.  This is the standard distributed FFT
    shape; the only inter-chip traffic is the single all_to_all.
  - MSM: points are sharded, each chip runs its local Pippenger window sums,
    and the (tiny) per-window partials are combined after an all_gather —
    group addition is not a ring psum over limb vectors, so the fold is done
    in the unified Jacobian combiner.
  - pointwise constraint evaluation (evaluate_h): embarrassingly parallel
    over the sharded extended domain; rotations become collective permutes
    only at shard boundaries.

Everything is expressed with shard_map so the same kernels run on one
device, an 8-device CPU mesh (tests), or several GPUs unchanged.
"""
from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P_

from ..fields import device as D
from ..fields.device import FR, NLIMB, U32
from ..fields import host as H
from ..ops import ntt as NTT


def default_mesh(n_devices: int = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), axis_names=("x",))


def mesh_2d(hosts: int, chips: int) -> Mesh:
    """Two-level mesh for multi-host topologies: axis "y" = hosts (the
    network between hosts), axis "x" = devices within a host (the fast
    intra-host links).  Shardings that flatten ("y","x") keep neighbor
    traffic (e.g. the h-VM halo exchanges) inside a host except at host
    boundaries, matching SURVEY §2.4's multi-node row."""
    devs = jax.devices()[: hosts * chips]
    return Mesh(np.array(devs).reshape(hosts, chips), axis_names=("y", "x"))


# ------------------------- distributed four-step NTT ------------------------

@functools.lru_cache(maxsize=32)
def _ntt_step_jit(mesh: Mesh, kr: int, kc: int):
    """Memoized jitted four-step NTT body.  jax.jit caches are keyed on the
    FUNCTION OBJECT: building the jit(shard_map(...)) closure inside
    distributed_ntt re-traced and re-compiled the ~25k-HLO program on every
    call (the exact per-program cost the one-program prover exists to
    avoid).  Jitting the whole sharded program (vs un-jitted shard_map) is
    still required: eager shard_map executes each primitive as a separate
    dispatch across all devices."""
    def step(m_local, tw_local, tw_r, tw_c):
        # m_local: (16, R, C/ndev)
        # 1) local NTT_R along r: move r to last axis
        s = jnp.moveaxis(m_local, 1, 2)              # (16, C/d, R)
        s = NTT.ntt_last_axis(s, tw_r, kr)
        s = jnp.moveaxis(s, 2, 1)                    # (16, R, C/d) : S[k1, c]
        # 2) twiddle
        t = D.mont_mul(s, tw_local, FR)
        # 3) transpose k1 <-> c across chips: all_to_all splits R into ndev
        #    chunks and concatenates the c chunks
        u = jax.lax.all_to_all(t, "x", split_axis=1, concat_axis=2, tiled=True)
        # u: (16, R/d, C) : T[k1 block, all c]
        u = NTT.ntt_last_axis(u, tw_c, kc)              # DFT over c: U[k1, k2]
        return u

    spec_in = P_(None, None, "x")
    return jax.jit(jax.shard_map(
        step, mesh=mesh,
        in_specs=(spec_in, spec_in, P_(None), P_(None)),
        out_specs=P_(None, "x", None)))


def distributed_ntt(a: jnp.ndarray, omega: int, k: int, mesh: Mesh) -> jnp.ndarray:
    """NTT of a (16, n) array, four-step over the mesh's "x" axis.

    n = R*C with C = a multiple of the device count; returns evaluations in
    natural order, matching ops/ntt.ntt (validated against it in tests).
    """
    n = 1 << k
    ndev = mesh.devices.size
    # choose R, C powers of two with C >= ndev
    kc = max((k + 1) // 2, (ndev - 1).bit_length())
    kr = k - kc
    R, C = 1 << kr, 1 << kc
    assert C % ndev == 0 and R >= 1

    omega_c = pow(omega, C, H.FR_MOD)      # order R
    omega_r = pow(omega, R, H.FR_MOD)      # order C
    tw_r = NTT.twiddle_table(omega_c, kr)  # local NTT_R twiddles
    tw_c = NTT.twiddle_table(omega_r, kc)  # local NTT_C twiddles
    # (twiddle tables travel as replicated ARGUMENTS so the jitted sharded
    # step below is memoized per (mesh, kr, kc) — see _ntt_step_jit)

    # full twiddle matrix W[k1, c] = omega^{c*k1}, sharded over c
    k1_idx = np.arange(R, dtype=object)
    tw_mat = np.zeros((NLIMB, R, C), dtype=np.uint32)
    # build in numpy with python ints (R*C = n entries; cached by caller size)
    wpow = np.empty((R, C), dtype=object)
    for k1 in range(R):
        base = pow(omega, k1, H.FR_MOD)
        cur = 1
        for c in range(C):
            wpow[k1, c] = cur
            cur = cur * base % H.FR_MOD
    flat = [int(x) for x in wpow.reshape(-1)]
    tw_mat = jnp.asarray(D.np_pack(flat, FR).reshape(NLIMB, R, C))

    # M[r, c] = x[r*C + c]: (16, R, C), shard over c
    M = a.reshape(NLIMB, R, C)
    U = _ntt_step_jit(mesh, kr, kc)(M, tw_mat, tw_r, tw_c)
    # out[k] with k = k1 + R*k2  => out = transpose(U) flattened
    return jnp.transpose(U, (0, 2, 1)).reshape(NLIMB, n)


# ------------------------- sharded MSM window sums --------------------------

def sharded_msm_window_sums(points, digits: jnp.ndarray, n: int, mesh: Mesh,
                            c: int = 8):
    """Per-window bucket-accumulated partial sums with points sharded over
    the mesh; local Pippenger per chip, per-chip partials gathered and folded
    by the Jacobian combiner.  Returns (n_windows, 3, 16) limb sums."""
    ndev = mesh.devices.size
    assert n % ndev == 0
    gathered = _msm_local_jit(mesh, n // ndev, c)(points, digits)
    return _fold_partials_jit(gathered)


@functools.lru_cache(maxsize=32)
def _msm_local_jit(mesh: Mesh, n_local: int, c: int):
    """Memoized jitted per-chip window sums (see _ntt_step_jit on why the
    jit must be built once per (mesh, statics), not per call)."""
    from ..ops.msm import _window_sums

    def local(points_l, digits_l):
        sums = _window_sums(points_l, digits_l, n_local, c)    # (nw, 3, 16)
        return jax.lax.all_gather(sums, "x")                   # (ndev, nw, 3, 16)

    spec_pts = (P_(None, "x"),) * 3
    return jax.jit(jax.shard_map(local, mesh=mesh,
                                 in_specs=(spec_pts, P_(None, "x")),
                                 out_specs=P_(None), check_vma=False))


@jax.jit
def _fold_partials_jit(g):
    """Fold ndev Jacobian partials (width = windows).  lax.scan shares ONE
    point_add body across the ndev-1 adds — an unrolled loop inlines ~25k
    HLO per add and blows up the XLA:CPU compile."""
    from ..curves import device as PD
    X = jnp.moveaxis(g[:, :, 0, :], -1, 1)     # (ndev, 16, nw)
    Y = jnp.moveaxis(g[:, :, 1, :], -1, 1)
    Z = jnp.moveaxis(g[:, :, 2, :], -1, 1)

    def step(acc, nxt):
        return PD.point_add(acc, tuple(nxt)), None

    acc, _ = jax.lax.scan(step, (X[0], Y[0], Z[0]),
                          jnp.stack([X[1:], Y[1:], Z[1:]], axis=1))
    return jnp.stack([jnp.moveaxis(acc[0], 0, 1),
                      jnp.moveaxis(acc[1], 0, 1),
                      jnp.moveaxis(acc[2], 0, 1)], axis=1)  # (nw, 3, 16)


# ------------------- sharded pointwise constraint evaluation ----------------

def sharded_pointwise_gate(values: jnp.ndarray, sel: jnp.ndarray,
                           y_limbs: jnp.ndarray, mesh: Mesh) -> jnp.ndarray:
    """A fused sharded h-style accumulation step:
    acc' = acc * y + sel * (values^2 - values)  on the sharded domain."""
    return _pointwise_jit(mesh)(values, sel, y_limbs)


@functools.lru_cache(maxsize=32)
def _pointwise_jit(mesh: Mesh):
    def step(v, s, y):
        sq = D.mont_mul(v, v, FR)
        term = D.mont_mul(s, D.sub(sq, v, FR), FR)
        return D.add(D.mont_mul(v, y, FR), term, FR)

    spec = P_(None, "x")
    return jax.jit(jax.shard_map(step, mesh=mesh,
                                 in_specs=(spec, spec, P_(None)),
                                 out_specs=spec, check_vma=False))
