"""Device h-polynomial evaluation — the prover's hot loop #1.

Mirrors plonk/evaluation.py's host `evaluate_h` (itself mirroring reference
evaluation.rs:285-551, same y-folding order) with every pointwise loop
replaced by fused jnp limb kernels over (16, extended_n) arrays.

The whole middle of the prover — basis conversions of every committed
polynomial, the h accumulation, division by the vanishing polynomial and the
inverse transform back to coefficients — runs as a SHORT pipeline of jitted
pieces per proving key (`build_h_fn`): one conversions piece, bounded
term-fold chunks (gates AND protocol terms, ~100 field ops each), and one
quotient piece.  All intermediate state stays device-resident, so a proof
pays only a handful of host<->device round trips.  (A single fused graph was
tried first: beyond ~1000 expression nodes XLA's algebraic simplifier goes
superlinear/circular and the SHA-256 circuit's h took >30 min to compile;
an unchunked protocol piece alone cost ~4 min per compile.)

Every large per-pk constant (fixed/sigma extended cosets, l0/l_last/
l_active selectors, vanishing-poly inverses, zeta patterns) travels through
the jit boundary as an ARGUMENT pytree, like the NttPlan digit matrices:
modules stay small, and compile-cache keys depend only on circuit SHAPE — two
circuits with the same constraint system and k (e.g. the 1-block and
64-block SHA-256 instances) share every compiled piece.

The prover uses this whenever create_proof's h_device resolves to True (the
default off the CPU); byte-identical proofs vs the host path are pinned in
tests.
"""
from __future__ import annotations

import functools
from typing import Dict, List, Optional

import jax
import jax.numpy as jnp

from ..fields import device as D
from ..fields import host as H
from ..fields.device import FR, NLIMB
from ..ops import ntt as NTT
from .circuit_ir import Expression

P = H.FR_MOD

_AOT_MAGIC = b"SHA2CQZ1"  # zlib-compressed AOT blob container


def _aot_blob_write(path, data: bytes) -> None:
    """Atomically write an AOT executable blob, zlib-compressed by default:
    the serialized h executable is ~58 MB raw and ~4x smaller compressed —
    less disk per cached shape and a faster cold read (SHA2CQ_AOT_COMPRESS=0
    opts out; readers accept both formats)."""
    import os
    import zlib
    if os.environ.get("SHA2CQ_AOT_COMPRESS", "1") == "1":
        data = _AOT_MAGIC + zlib.compress(data, 1)
    with open(path + ".tmp", "wb") as f:
        f.write(data)
    os.replace(path + ".tmp", path)


def _aot_blob_read(path):
    """Read an AOT blob written by _aot_blob_write (either format);
    returns the unpickled (blob, in_tree, out_tree) triple."""
    import pickle
    import zlib
    with open(path, "rb") as f:
        data = f.read()
    if data[:len(_AOT_MAGIC)] == _AOT_MAGIC:
        data = zlib.decompress(data[len(_AOT_MAGIC):])
    return pickle.loads(data)


def _aot_load(path):
    """Deserialize a one-device executable blob onto the default device.
    Left to itself, deserialize_and_load spreads an executable over every
    local device, so a blob compiled for one device, loaded in a process
    that sees four, expects four shards per argument and fails at its first
    dispatch."""
    from jax.experimental.serialize_executable import deserialize_and_load
    return deserialize_and_load(*_aot_blob_read(path),
                                execution_devices=jax.devices()[:1])


def _aot_prune(d: str, keep: Optional[int] = None) -> None:
    """Drop all but the `keep` most-recently-USED h_all blobs in dir `d`.
    Recency = mtime, refreshed via os.utime on every cache hit, so this is
    LRU rather than write-order; SHA2CQ_AOT_KEEP sets the limit (default 64
    — a serving process cycling through more distinct pk shapes than that
    should raise it or thrash silently; VERDICT r4 #8)."""
    import os
    try:
        if keep is None:
            keep = int(os.environ.get("SHA2CQ_AOT_KEEP", "64"))
        blobs = sorted(
            (f for f in os.listdir(d)
             if f.startswith("h_all-") and f.endswith(".pkl")),
            key=lambda f: os.path.getmtime(os.path.join(d, f)), reverse=True)
        for old in blobs[keep:]:
            os.remove(os.path.join(d, old))
    except Exception:
        pass


@jax.jit
def _mont_mul_jit(a, b):
    """Elementwise Montgomery multiply as its own tiny stable-keyed program
    (see convert_eager/quotient_eager)."""
    return D.mont_mul(a, b, FR)


@functools.partial(jax.jit, static_argnums=(3, 4, 5))
def _c2e_chunk(coeff, zeta_fwd, plan, res_omega, p_name, out_n):
    """coeff (16, cb, n) -> extended-coset evals (16, cb, out_n): ZETA-coset
    scale, zero-pad to the extended size, forward matmul NTT.  A small
    stable-keyed program shared by every 16-column chunk (see run())."""
    from ..ops import mxu_ntt as MX
    ctx = FR if p_name == "Fr" else D.FQ
    a = D.mont_mul(coeff, zeta_fwd[:, None, :], ctx)
    pad = jnp.zeros((NLIMB, a.shape[1], out_n - a.shape[2]), dtype=a.dtype)
    return MX.mxu_ntt_batch(jnp.concatenate([a, pad], axis=2), plan,
                            res_omega, ctx)


def _const(v: int):
    return D.pack_scalar(v, FR).reshape(NLIMB, 1)


def build_h_fn(pk, use_mxu: Optional[bool] = None, max_chunk_nodes: int = 100):
    """Returns fn(inputs) -> h coefficient array (16, n*quotient), where fn
    wraps a short pipeline of jitted pieces (conversions, term-fold chunks,
    quotient) with all intermediate state device-resident.

    inputs pytree (all Montgomery limb arrays):
      advice   : (16, C_a, n)   Lagrange advice columns
      instance : (16, C_i, n)   Lagrange instance columns
      z        : (16, S, n)     permutation grand products (Lagrange)
      lookups  : (16, 3L, n)    product/permuted-input/permuted-table triples
      static   : (16, 2Q, n)    CQ (b, f) coefficient pairs
      scalars  : {"y","beta","gamma","theta"} (16, 1) + "challenges" (16,ch,1)

    use_mxu: route every basis conversion through the int8 matmul-NTT
    (ops/mxu_ntt.py) instead of uint32 butterflies (ops/ntt.py).  Auto: on
    for k >= 12."""
    import numpy as np

    from ..ops import mxu_ntt as MX

    domain = pk.vk.domain
    cs = pk.vk.cs
    size = domain.extended_n
    rot_scale = 1 << (domain.extended_k - domain.k)
    if use_mxu is None:
        # auto: k >= 12 on every backend (the H100 numbers behind the rule
        # are in PERF.md, "matmul NTT vs butterfly NTT")
        use_mxu = domain.k >= 12

    from ..utils.profiling import profiler as _prof

    plans = {}
    res_omegas = {}
    with _prof.phase("plans"):
        if use_mxu:
            for name, (nn, om) in {
                "l2c": (domain.n, domain.omega_inv),
                "c2e": (size, domain.extended_omega),
                "e2c": (size, domain.extended_omega_inv),
            }.items():
                plan, res_om = MX.get_plan(nn, om, "Fr")
                plans[name] = plan
                res_omegas[name] = res_om
    ifft_div = _const(domain.ifft_divisor)
    ext_ifft_div = _const(domain.extended_ifft_divisor)

    # ---- per-pk constants, passed as jit arguments (see module docstring) --
    # column stacks are assembled in NUMPY (one host->device transfer each,
    # no per-column device programs)
    def np_stack(cols):
        # fixed/sigma cosets ship and LIVE as uint16 (canonical limbs are
        # 16-bit): half the device memory of u32 copies (377 MB saved at
        # SHA-256 k=15).  Consumers widen at the use site (XLA fuses the
        # convert into the next op).
        if not cols:
            return jnp.zeros((NLIMB, 0, size), dtype=jnp.uint16)
        flat = [v for c in cols for v in c]
        return jnp.asarray(D.np_pack(flat, FR).reshape(NLIMB, len(cols), -1)
                           .astype(np.uint16))

    coset_pts = NTT.powers_host(domain.extended_omega, size, P)
    with _prof.phase("fixed_cosets"):
        fixed_stack = np_stack(pk.fixed_cosets)
    with _prof.phase("sigma_cosets"):
        sigma_stack = np_stack(pk.permutation.cosets)
    with _prof.phase("misc_consts"):
        consts = {
            "fixed": fixed_stack,
            "sigma": sigma_stack,
            "l0": D.pack(pk.l0, FR),
            "l_last": D.pack(pk.l_last, FR),
            "l_active": D.pack(pk.l_active_row, FR),
            "vanishing_inv": jnp.asarray(
                np.tile(D.np_pack(domain.t_evaluations_inv, FR),
                        size // len(domain.t_evaluations_inv))),
            "zeta_times_coset": D.pack(
                [H.FR_ZETA * w % P for w in coset_pts], FR),
            "zeta_fwd": domain._zeta_pattern(domain.n, True),
            "zeta_bwd": domain._zeta_pattern(size, False),
        }

    bf = cs.blinding_factors()
    chunk_len = max(pk.vk.cs_degree - 2, 1)
    columns = cs.permutation.columns
    num_sets = (len(columns) + chunk_len - 1) // chunk_len if columns else 0

    def roll(a, rot):
        return jnp.roll(a, -rot * rot_scale, axis=1)

    def coeff_to_extended_b(coeff, mxu_plans, cn):
        if use_mxu:
            a = D.mont_mul(coeff, cn["zeta_fwd"][:, None, :], FR)
            pad = jnp.zeros((NLIMB, a.shape[1], size - domain.n), dtype=a.dtype)
            a = jnp.concatenate([a, pad], axis=2)
            return MX.mxu_ntt_batch(a, mxu_plans["c2e"], res_omegas["c2e"])
        return domain.coeff_to_extended_batch(coeff)

    def to_coset_batch(lag, mxu_plans, cn, want_coeff=False):
        if use_mxu:
            coeff = MX.mxu_ntt_batch(lag, mxu_plans["l2c"], res_omegas["l2c"])
            coeff = D.mont_mul(coeff, ifft_div[:, None, :], FR)
        else:
            coeff = domain.lagrange_to_coeff_batch(lag)
        ext = coeff_to_extended_b(coeff, mxu_plans, cn)
        return (ext, coeff) if want_coeff else ext

    # ---- piece 0: basis conversions (NTT-heavy, few distinct ops) ---------
    def convert_fn(inputs, mxu_plans, cn):
        def conv(a):
            return to_coset_batch(a, mxu_plans, cn) if a.shape[1] else \
                jnp.zeros((NLIMB, 0, size), dtype=a.dtype)
        # the advice lagrange->coeff intermediate doubles as the prover's
        # x-eval polynomials (prover.py h-path) — returning it here removes
        # the duplicated advice NTT the prover used to run (~0.34 s at k=14)
        if inputs["advice"].shape[1]:
            adv_ext, adv_coeff = to_coset_batch(
                inputs["advice"], mxu_plans, cn, want_coeff=True)
        else:
            adv_ext = jnp.zeros((NLIMB, 0, size), dtype=inputs["advice"].dtype)
            adv_coeff = jnp.zeros((NLIMB, 0, domain.n),
                                  dtype=inputs["advice"].dtype)
        return {
            "advice": adv_ext,
            "advice_coeff": adv_coeff,
            "instance": conv(inputs["instance"]),
            "z": conv(inputs["z"]),
            "lk": conv(inputs["lookups"]),
            "st": (coeff_to_extended_b(inputs["static"], mxu_plans, cn)
                   if inputs["static"].shape[1]
                   else jnp.zeros((NLIMB, 0, size), dtype=inputs["static"].dtype)),
        }

    def make_eval_expr(state, sc, cn):
        advice, instance = state["advice"], state["instance"]

        def eval_expr(expr: Expression):
            ops = {
                "const": lambda v: _const(v),
                "selector": lambda e: (_ for _ in ()).throw(ValueError("selector")),
                "fixed": lambda e: roll(
                    cn["fixed"][:, e.column.index].astype(D.U32), e.rotation),
                "advice": lambda e: roll(advice[:, e.column.index], e.rotation),
                "instance": lambda e: roll(instance[:, e.column.index], e.rotation),
                "challenge": lambda e: sc["challenges"][:, e.value],
                "neg": lambda a: D.neg(a, FR),
                "sum": lambda a, b: D.add(a, b, FR),
                "prod": lambda a, b: D.mont_mul(a, b, FR),
                "scaled": lambda a, v: D.mont_mul(a, _const(v), FR),
            }
            out = expr.evaluate(ops)
            if out.shape[-1] == 1:
                out = jnp.broadcast_to(out, (NLIMB, size))
            return out

        return eval_expr

    def fold(acc, y, term):
        return D.add(D.mont_mul(acc, y, FR), term, FR)

    def col_coset(state, cn, column):
        if column.kind == "advice":
            return state["advice"][:, column.index]
        if column.kind == "fixed":
            return cn["fixed"][:, column.index].astype(D.U32)
        return state["instance"][:, column.index]

    # ---- term chunking -----------------------------------------------------
    # One giant fused graph (1000+ expression nodes x ~300 HLO ops per
    # mont_mul) sends XLA's algebraic simplifier into its superlinear/
    # circular regime (observed: >30 min compiles for the SHA circuit's h;
    # ~4 min for an unchunked protocol piece even at k=3).  EVERY stage —
    # gates AND protocol terms — is therefore grouped into bounded chunks
    # (~max_chunk_nodes field ops each); chunks compile linearly and cost
    # one extra dispatch each.
    def expr_nodes(e):
        return e.evaluate({
            "const": lambda v: 1, "selector": lambda e: 1,
            "fixed": lambda e: 1, "advice": lambda e: 1,
            "instance": lambda e: 1, "challenge": lambda e: 1,
            "neg": lambda a: a + 1, "sum": lambda a, b: a + b + 1,
            "prod": lambda a, b: a + b + 1, "scaled": lambda a, v: a + 1,
        })

    # each work item: (cost_estimate, emit(values, state, sc, cn) -> values),
    # in the exact host evaluate_h fold order (proofs must stay byte-equal)
    items = []

    for gate in cs.gates:
        for poly in gate.polys:
            def emit_gate(values, state, sc, cn, poly=poly):
                return fold(values, sc["y"],
                            make_eval_expr(state, sc, cn)(poly))
            items.append((expr_nodes(poly), emit_gate))

    if num_sets:
        def emit_perm_head(values, state, sc, cn):
            one = D.ones((size,), FR)
            first = state["z"][:, 0]
            last = state["z"][:, num_sets - 1]
            values = fold(values, sc["y"],
                          D.mont_mul(D.sub(one, first, FR), cn["l0"], FR))
            return fold(values, sc["y"], D.mont_mul(
                D.sub(D.mont_mul(last, last, FR), last, FR), cn["l_last"], FR))
        items.append((5, emit_perm_head))

        for i in range(1, num_sets):
            def emit_boundary(values, state, sc, cn, i=i):
                term = D.sub(state["z"][:, i],
                             roll(state["z"][:, i - 1], -(bf + 1)), FR)
                return fold(values, sc["y"], D.mont_mul(term, cn["l0"], FR))
            items.append((3, emit_boundary))

        for chunk_idx in range(num_sets):
            def emit_perm_set(values, state, sc, cn, chunk_idx=chunk_idx):
                y, beta, gamma = sc["y"], sc["beta"], sc["gamma"]
                z = state["z"][:, chunk_idx]
                cols = columns[chunk_idx * chunk_len:(chunk_idx + 1) * chunk_len]
                left = roll(z, 1)
                for j, column in enumerate(cols):
                    sigma = cn["sigma"][:, chunk_idx * chunk_len + j] \
                        .astype(D.U32)
                    vals = col_coset(state, cn, column)
                    left = D.mont_mul(left, D.add(
                        D.add(vals, D.mont_mul(beta, sigma, FR), FR),
                        gamma, FR), FR)
                right = z
                delta_pow = pow(H.FR_DELTA, chunk_idx * chunk_len, P)
                cur_delta = D.mont_mul(
                    D.mont_mul(cn["zeta_times_coset"], beta, FR),
                    _const(delta_pow), FR)
                for column in cols:
                    vals = col_coset(state, cn, column)
                    right = D.mont_mul(
                        right, D.add(D.add(vals, cur_delta, FR), gamma, FR), FR)
                    cur_delta = D.mont_mul(cur_delta, _const(H.FR_DELTA), FR)
                return fold(values, y, D.mont_mul(
                    D.sub(left, right, FR), cn["l_active"], FR))
            items.append((4 + 5 * chunk_len, emit_perm_set))

    for n_lk, arg in enumerate(cs.lookups):
        def emit_lookup(values, state, sc, cn, n_lk=n_lk, arg=arg):
            y, beta, gamma, theta = (sc["y"], sc["beta"], sc["gamma"],
                                     sc["theta"])
            one = D.ones((size,), FR)
            eval_expr = make_eval_expr(state, sc, cn)
            product = state["lk"][:, 3 * n_lk]
            inp = state["lk"][:, 3 * n_lk + 1]
            tab = state["lk"][:, 3 * n_lk + 2]
            comp_in = D.zeros((size,), FR)
            for e in arg.input_expressions:
                comp_in = D.add(D.mont_mul(comp_in, theta, FR), eval_expr(e), FR)
            comp_tab = D.zeros((size,), FR)
            for e in arg.table_expressions:
                comp_tab = D.add(D.mont_mul(comp_tab, theta, FR), eval_expr(e), FR)
            a_minus_s = D.sub(inp, tab, FR)
            values = fold(values, y, D.mont_mul(D.sub(one, product, FR),
                                                cn["l0"], FR))
            values = fold(values, y, D.mont_mul(
                D.sub(D.mont_mul(product, product, FR), product, FR),
                cn["l_last"], FR))
            table_value = D.mont_mul(D.add(comp_in, beta, FR),
                                     D.add(comp_tab, gamma, FR), FR)
            left = D.mont_mul(D.mont_mul(roll(product, 1),
                                         D.add(inp, beta, FR), FR),
                              D.add(tab, gamma, FR), FR)
            values = fold(values, y, D.mont_mul(
                D.sub(left, D.mont_mul(product, table_value, FR), FR),
                cn["l_active"], FR))
            values = fold(values, y, D.mont_mul(a_minus_s, cn["l0"], FR))
            return fold(values, y, D.mont_mul(
                D.mont_mul(a_minus_s, D.sub(inp, roll(inp, -1), FR), FR),
                cn["l_active"], FR))
        cost = 20 + sum(expr_nodes(e) for e in
                        list(arg.input_expressions) + list(arg.table_expressions))
        items.append((cost, emit_lookup))

    for i in range(len(cs.static_lookups)):
        def emit_cq(values, state, sc, cn, i=i):
            one = D.ones((size,), FR)
            b_coset = state["st"][:, 2 * i]
            f_coset = state["st"][:, 2 * i + 1]
            if getattr(cs, "zk_static_lookups", False):
                # zk gate shape: l_active * (B(f+beta) - 1)
                term = D.mont_mul(
                    b_coset, D.add(f_coset, sc["beta"], FR), FR)
                term = D.mont_mul(D.sub(term, one, FR), cn["l_active"], FR)
                return fold(values, sc["y"], term)
            term = D.mont_mul(
                b_coset, D.add(D.mont_mul(f_coset, cn["l_active"], FR),
                               sc["beta"], FR), FR)
            return fold(values, sc["y"], D.sub(term, one, FR))
        items.append((4, emit_cq))

    chunks: List[list] = []
    cur: list = []
    cur_nodes = 0
    for cost, emit in items:
        if cur and cur_nodes + cost > max_chunk_nodes:
            chunks.append(cur)
            cur, cur_nodes = [], 0
        cur.append(emit)
        cur_nodes += cost
    if cur:
        chunks.append(cur)

    def make_chunk_fn(emits):
        def chunk_fn(values, state, sc, cn):
            for emit in emits:
                values = emit(values, state, sc, cn)
            return values
        return jax.jit(chunk_fn)

    # Scanned bytecode VM (plonk/h_vm.py) replaces the unrolled chunk graphs:
    # per-process trace/lower/compile of the ~20 10^5-node chunk modules
    # measured 601 s of a 778 s warm SHA-256 prove; the VM compiles one tiny
    # scan body instead.  SHA2CQ_H_VM=0 falls back to the chunk pipeline.
    # Mesh-sharded inputs run the shard_map VM (h_vm.run_program_sharded):
    # rows sharded over the mesh, rotations via one-time halo exchanges, no
    # GSPMD partitioner involvement (the fused h graphs measured 12+ min to
    # partition on XLA:CPU, and the single-device VM's dynamic column index
    # would become a per-instruction cross-device gather under GSPMD).
    import os as _os
    use_vm = _os.environ.get("SHA2CQ_H_VM", "1") == "1"
    # ---- coset-streamed h (the k>=18 single-chip path) --------------------
    # The extended-coset evaluation decomposes EXACTLY into rs = ext/n
    # rotation-closed n-cosets: ext index j = rs*i + t evaluates P at
    # (ZETA*w_ext^t) * w_n^i, i.e. an n-NTT of the coeffs twisted by
    # (ZETA*w_ext^t)^d — and every h-fold rotation rolls by multiples of
    # rs, so it never crosses cosets.  Streaming the VM per coset caps the
    # resident column state at 1/rs of the monolithic ext stacks (the SHA
    # circuit's k=18 has ext = 2^19 x ~200 columns), at the cost of
    # converting fixed/sigma from coeffs per prove instead of using the
    # precomputed ext cosets.  Auto-on at ext >= 2^19; SHA2CQ_H_COSETS=1/0
    # forces.  The threshold was sized for an earlier accelerator with
    # 16 GB of device memory and has not been measured on the H100's 80 GB.
    rs_cosets = size // domain.n
    _cosets_env = _os.environ.get("SHA2CQ_H_COSETS", "auto")
    use_cosets = (use_mxu and use_vm and rs_cosets > 1 and
                  (_cosets_env == "1" or
                   (_cosets_env == "auto" and size >= (1 << 19))))
    if use_cosets:
        print(f"[h] coset-streamed path on (ext=2^{size.bit_length() - 1}, "
              f"rs={rs_cosets})", flush=True)
    vm_prog = None
    vm_prog_coset = None
    if use_vm:
        from . import h_vm as _h_vm
        vm_prog = _h_vm.assemble_h_program(pk)
        if use_cosets:
            vm_prog_coset = _h_vm.assemble_h_program(pk, rot_scale=1)
            assert vm_prog_coset.const_scalars == vm_prog.const_scalars
    if use_cosets:
        with _prof.phase("coset_consts"):
            plan_nf, res_nf = MX.get_plan(domain.n, domain.omega, "Fr")
            plans["n_fwd"] = plan_nf
            res_omegas["n_fwd"] = res_nf
            tw = []
            for t in range(rs_cosets):
                base = H.FR_ZETA * pow(domain.extended_omega, t, P) % P
                tw.append(D.np_pack(NTT.powers_host(base, domain.n, P), FR))
            consts["coset_twist"] = jnp.asarray(np.stack(tw, 0))

            def np_stack_coeff(cols):
                if not cols:
                    return jnp.zeros((NLIMB, 0, domain.n), dtype=jnp.uint16)
                if all(isinstance(c, np.ndarray) for c in cols):
                    packed = D.np_pack_buf(np.concatenate(cols), FR)
                else:
                    from ..poly.arith import as_coeff_list
                    packed = D.np_pack(
                        [v for c in (as_coeff_list(c) for c in cols)
                         for v in c], FR)
                return jnp.asarray(
                    packed.reshape(NLIMB, len(cols), domain.n)
                    .astype(np.uint16))

            consts["fixed_coeff"] = np_stack_coeff(pk.fixed_polys)
            consts["sigma_coeff"] = np_stack_coeff(pk.permutation.polys)
    chunk_jits: List = []  # built lazily (only the fallback path pays tracing)

    def ensure_chunk_jits():
        if not chunk_jits:
            chunk_jits.extend(make_chunk_fn(emits) for emits in chunks)
        return chunk_jits

    def is_multidevice(a) -> bool:
        sh = getattr(a, "sharding", None)
        dev = getattr(sh, "device_set", None)
        return dev is not None and len(dev) > 1

    # ---- quotient: divide by t(X) on the coset, back to coefficients ------
    def quotient_fn(values, cn, mxu_plans):
        values = D.mont_mul(values, cn["vanishing_inv"], FR)
        if use_mxu:
            a = MX.mxu_ntt_batch(values[:, None, :], mxu_plans["e2c"],
                                 res_omegas["e2c"])[:, 0]
            a = D.mont_mul(a, ext_ifft_div, FR)
            a = D.mont_mul(a, cn["zeta_bwd"], FR)
            return a[:, : domain.n * domain.quotient_poly_degree]
        return domain.extended_to_coeff(values)

    convert_jit = jax.jit(convert_fn)
    quotient_jit = jax.jit(quotient_fn)

    def quotient_eager(values):
        """Quotient as three small dispatches (small stable-keyed programs,
        as in convert_eager; the fused 1/n scale in the e2c NTT is
        value-identical to canonicalize-then-scale)."""
        v = _mont_mul_jit(values, consts["vanishing_inv"])
        a = MX._mxu_batch_scaled_jit(
            v[:, None, :], plans["e2c"], res_omegas["e2c"], "Fr",
            domain.extended_ifft_divisor % H.FR_MOD)
        a = _mont_mul_jit(a[:, 0], consts["zeta_bwd"])
        return a[:, : domain.n * domain.quotient_poly_degree]

    def convert_eager(inputs):
        """Single-device matmul-NTT conversions as per-16-column-chunk
        dispatches (the path when the one-program h is off).

        The monolithic convert graph at SHA-256 scale (~100 columns, k=13)
        compiles to a ~23 MB executable; the chunk programs are the same
        small stable-keyed executables as the bench NTT kernels, and the
        math is value-identical (canonical forms are unique, so the fused
        1/n scale equals canonicalize-then-scale bit for bit)."""
        from ..ops import mxu_ntt as MX

        def l2c_f(x):
            return MX._mxu_batch_scaled_jit(
                x, plans["l2c"], res_omegas["l2c"], "Fr",
                domain.ifft_divisor % H.FR_MOD)

        def c2e_f(x):
            return _c2e_chunk(x, consts["zeta_fwd"], plans["c2e"],
                              res_omegas["c2e"], "Fr", size)

        def chunks(x, f, out_n):
            C = x.shape[1]
            if C == 0:
                return jnp.zeros((NLIMB, 0, out_n), dtype=x.dtype)
            outs = [f(x[:, lo:lo + 16]) for lo in range(0, C, 16)]
            return outs[0] if len(outs) == 1 else jnp.concatenate(outs, axis=1)

        def conv(x):
            return chunks(chunks(x, l2c_f, domain.n), c2e_f, size)

        adv_coeff = chunks(inputs["advice"], l2c_f, domain.n)
        return {
            "advice": chunks(adv_coeff, c2e_f, size),
            "advice_coeff": adv_coeff,
            "instance": conv(inputs["instance"]),
            "z": conv(inputs["z"]),
            "lk": conv(inputs["lookups"]),
            "st": chunks(inputs["static"], c2e_f, size),
        }

    # ---- ONE-PROGRAM single-device path ------------------------------------
    # The eager chunked pipeline above issues ~25-40 distinct programs per
    # prove (per-chunk NTTs, slices, concats, group stacking), each with its
    # own compile, load and dispatch.  This path fuses conversions + the
    # h-VM + the quotient into ONE stable-keyed program (lax.map-chunked
    # NTTs keep its size column-count-independent), so a prove pays one
    # compile or cache load and one dispatch.
    def h_all_fn(adv, inst, zc, lkc, st_b, st_f, scal, instrs, cn, pls, dims):
        (Ca, Ci, Cz, Cl, res_l2c, res_c2e, res_e2c, n_reg, out_reg) = dims
        from . import h_vm as _h_vm
        from ..ops import mxu_ntt as MXX

        # lax.map chunk sized so the per-chunk working set (the mont_mul
        # deferred-carry temps, ~33 x 16*chunk*n*4 B, and the level-0 int32
        # matmul) stays in the 1-2 GB range instead of scaling with the
        # column count
        def pick_chunk(nn):
            return max(8, min(64, (1 << 20) // nn))

        # lagrange -> coeff with the 1/n divisor fused at the residual
        # level; u16 in (widened per chunk), u16 out (canonical limbs)
        lag16 = jnp.concatenate([adv, inst, zc, lkc], axis=1)
        coeff = MXX.mxu_ntt_batch_mapped(
            lag16, pls["l2c"], res_l2c, FR, chunk=pick_chunk(domain.n),
            scale=cn["ifft_div"], out_dtype=jnp.uint16)
        # CQ (b, f) coeff pairs arrive as TWO stacks so the beta-independent
        # f half could start its host->device transfer during the CQ
        # phases; interleave back to the [b0, f0, b1, f1, ...] group layout
        Q = st_b.shape[1]
        static_cols = jnp.stack([st_b, st_f], axis=2).reshape(
            NLIMB, 2 * Q, st_b.shape[2])
        ext_in = jnp.concatenate([coeff, static_cols], axis=1)
        # coeff -> extended-coset evals: ZETA scale, zero-pad and NTT all
        # inside the map body (per-chunk working set); u16 extended state
        ext = MXX.mxu_ntt_batch_mapped(
            ext_in, pls["c2e"], res_c2e, FR, chunk=pick_chunk(size),
            pre_mult=cn["zeta_fwd"], pad_to=size, out_dtype=jnp.uint16)

        def pad1(a):
            return a if a.shape[1] else jnp.zeros((NLIMB, 1, size),
                                                  dtype=a.dtype)

        o1, o2, o3 = Ca, Ca + Ci, Ca + Ci + Cz
        o4 = o3 + Cl
        groups = {
            "advice": pad1(ext[:, :Ca]),
            "instance": pad1(ext[:, o1:o2]),
            "fixed": pad1(cn["fixed"]),
            "sigma": pad1(cn["sigma"]),
            "z": pad1(ext[:, o2:o3]),
            "lk": pad1(ext[:, o3:o4]),
            "st": pad1(ext[:, o4:]),
            "aux": jnp.stack([cn["l0"], cn["l_last"], cn["l_active"],
                              cn["zeta_times_coset"]], axis=1),
        }
        regs0 = jnp.zeros((NLIMB, n_reg, size), dtype=D.U32)
        regs = _h_vm._vm_scan(instrs, regs0, groups, scal)
        values = regs[:, out_reg]

        # quotient (identical op order to quotient_eager: canonical forms
        # are unique, so fused 1/n == canonicalize-then-scale bit for bit)
        v = D.mont_mul(values, cn["vanishing_inv"], FR)
        q = MXX.mxu_ntt_batch_mapped(
            v[:, None, :], pls["e2c"], res_e2c, FR,
            scale=cn["ext_ifft_div"])[:, 0]
        q = D.mont_mul(q, cn["zeta_bwd"], FR)
        h_out = q[:, : domain.n * domain.quotient_poly_degree]
        # advice coeffs return as u16 (canonical limbs < 2^16): halves the
        # ~50 MB device->host fetch for the x-eval polynomials
        return h_out, coeff[:, :Ca]    # already u16 (canonical limbs)

    def h_coset_fn(adv, inst, zc, lkc, st_b, st_f, scal, instrs, cn, pls,
                   dims):
        """Coset-streamed variant of h_all_fn (see use_cosets above): ONE
        executable that lax.maps the convert+VM over the rs rotation-closed
        cosets, holding 1/rs of the ext column state at a time.  Values are
        bit-identical (canonical forms are unique; the coset NTTs compute
        the same field elements the monolithic ext NTT does)."""
        (Ca, Ci, Cz, Cl, res_l2c, res_nf, res_e2c, n_reg, out_reg) = dims[:9]
        from . import h_vm as _h_vm
        from ..ops import mxu_ntt as MXX

        nn = domain.n

        # tighter chunk floor than h_all_fn, for the k>=18 coset program
        # (the ~33 mont_mul deferred-carry temps are 16*chunk*n*4 B each)
        def pick_chunk(x):
            return max(4, min(64, (1 << 19) // x))

        lag16 = jnp.concatenate([adv, inst, zc, lkc], axis=1)
        coeff = MXX.mxu_ntt_batch_mapped(
            lag16, pls["l2c"], res_l2c, FR, chunk=pick_chunk(nn),
            scale=cn["ifft_div"], out_dtype=jnp.uint16)
        Q = st_b.shape[1]
        st = jnp.stack([st_b, st_f], axis=2).reshape(NLIMB, 2 * Q, nn)

        def pad1(a):
            return a if a.shape[1] else jnp.zeros((NLIMB, 1, nn),
                                                  dtype=jnp.uint16)

        o1, o2, o3 = Ca, Ca + Ci, Ca + Ci + Cz
        o4 = o3 + Cl
        # ext vectors viewed as (16, n, rs): ext index j = rs*i + t
        aux_r = jnp.stack(
            [cn["l0"], cn["l_last"], cn["l_active"],
             cn["zeta_times_coset"]],
            axis=1).reshape(NLIMB, 4, nn, rs_cosets)

        def per_coset(t):
            twist = cn["coset_twist"][t]

            def conv(x16):
                return MXX.mxu_ntt_batch_mapped(
                    x16, pls["n_fwd"], res_nf, FR, chunk=pick_chunk(nn),
                    pre_mult=twist, out_dtype=jnp.uint16)

            groups = {
                "advice": conv(pad1(coeff[:, :Ca])),
                "instance": conv(pad1(coeff[:, o1:o2])),
                "fixed": conv(pad1(cn["fixed_coeff"])),
                "sigma": conv(pad1(cn["sigma_coeff"])),
                "z": conv(pad1(coeff[:, o2:o3])),
                "lk": conv(pad1(coeff[:, o3:o4])),
                "st": conv(pad1(st)),
                "aux": aux_r[:, :, :, t],
            }
            regs0 = jnp.zeros((NLIMB, n_reg, nn), dtype=D.U32)
            regs = _h_vm._vm_scan(instrs, regs0, groups, scal)
            return regs[:, out_reg]

        values8 = jax.lax.map(per_coset, jnp.arange(rs_cosets))
        # ext index j = rs*i + t  ->  (16, n, rs) flattened i-major
        values = jnp.transpose(values8, (1, 2, 0)).reshape(NLIMB, size)

        v = D.mont_mul(values, cn["vanishing_inv"], FR)
        q = MXX.mxu_ntt_batch_mapped(
            v[:, None, :], pls["e2c"], res_e2c, FR,
            scale=cn["ext_ifft_div"])[:, 0]
        q = D.mont_mul(q, cn["zeta_bwd"], FR)
        h_out = q[:, : domain.n * domain.quotient_poly_degree]
        return h_out, coeff[:, :Ca]

    h_all_jit = jax.jit(h_all_fn, static_argnums=(10,))
    h_coset_jit = jax.jit(h_coset_fn, static_argnums=(10,))
    import os as _os2
    use_oneprog = (use_mxu and vm_prog is not None and
                   _os2.environ.get("SHA2CQ_H_ONEPROG", "1") == "1")
    aot_memo: dict = {}
    instrs_memo: dict = {}   # per-pk VM instruction arrays, device-resident

    def _aot_cache_key(args):
        """Executable-identity key WITHOUT lowering.  The compiled h_all
        executable is fully determined by (a) the shapes/dtypes of its traced
        arguments + the static dims tuple, (b) the tracing code, and (c) the
        jax/backend version — instrs/consts/scalars are traced ARGUMENTS, so
        their values don't enter the program.  Keying on the lowered HLO text
        (the first implementation) cost a 15 s lower() per process and was
        fragile: HLO text embeds source loc() line numbers, so ANY edit to
        this file forced a 30 s-8 min remote recompile.  (b) is covered by
        hashing the source bytes of every module the trace runs through."""
        import hashlib
        spec = jax.tree_util.tree_map(
            lambda a: (tuple(a.shape), str(a.dtype))
            if hasattr(a, "shape") else a, args[:10])
        backend = jax.devices()[0].client
        h = hashlib.sha256(repr(spec).encode())
        h.update(repr(args[10]).encode())         # static dims tuple
        import sys
        from ..fields import device as _dmod
        from ..ops import mxu_ntt as _mxmod
        from . import h_vm as _hvmod
        for mod in (sys.modules[__name__], _hvmod, _mxmod, _dmod):
            try:
                with open(mod.__file__, "rb") as f:
                    h.update(f.read())
            except Exception:
                h.update(repr(mod).encode())
        h.update((jax.__version__
                  + str(getattr(backend, "platform_version", ""))).encode())
        return h.hexdigest()[:24]

    def _aot_executable(args, jit_fn=None):
        """Process-spanning compiled-executable cache for the fused h
        program: the executable is serialized
        (jax.experimental.serialize_executable) into the compile-cache dir
        keyed on _aot_cache_key, so a fresh process pays one deserialize
        instead of a compile even where JAX's persistent cache misses.
        Whether it still earns its place beside that cache is measured by
        chip_smoke.py's two fresh-process runs (PERF.md).  Returns None when
        disabled/unavailable — caller uses h_all_jit."""
        if (_os2.environ.get("SHA2CQ_AOT_CACHE", "1") != "1"
                or aot_memo.get("failed")):
            return None
        try:
            import pickle

            from jax.experimental.serialize_executable import serialize
            from ..utils.profiling import profiler as _prof
            key = _aot_cache_key(args)
            if _os2.environ.get("SHA2CQ_AOT_DEBUG"):
                spec = jax.tree_util.tree_map(
                    lambda a: (tuple(a.shape), str(a.dtype))
                    if hasattr(a, "shape") else a, args[:9])
                print(f"[h_all aot] key {key} spec {spec!r:.400}", flush=True)
            exe = aot_memo.get(key)
            if exe is not None:
                return exe
            cache_dir = jax.config.jax_compilation_cache_dir
            path = None
            if cache_dir:
                path = _os2.path.join(cache_dir, "aot", f"h_all-{key}.pkl")
            if path and _os2.path.exists(path):
                with _prof.phase("aot_deser"):
                    exe = _aot_load(path)
                    aot_memo["loaded_from"] = path
                    # LRU marker: prune keys on mtime, so a cache hit must
                    # refresh it or a >keep-shape service would evict its
                    # hottest blobs by write order (VERDICT r4 #8)
                    try:
                        _os2.utime(path)
                    except OSError:
                        pass
            else:
                with _prof.phase("aot_compile"):
                    exe = (jit_fn or h_all_jit).lower(*args).compile()
                if path:
                    _os2.makedirs(_os2.path.dirname(path), exist_ok=True)
                    _aot_blob_write(path, pickle.dumps(serialize(exe),
                                                       protocol=4))
                    _aot_prune(_os2.path.dirname(path))
        except Exception as e:  # AOT is an optimization only
            print(f"[h_all aot] disabled: {e!r:.120}", flush=True)
            aot_memo["failed"] = True
            return None
        aot_memo[key] = exe
        return exe

    def run_oneprog(inputs):
        import numpy as np
        from ..utils.profiling import profiler
        raw = inputs["scalars_raw"]
        scal_np = D.np_pack(
            [raw["y"], raw["beta"], raw["gamma"], raw["theta"]]
            + list(raw["challenges"]) + list(vm_prog.const_scalars), FR)
        with profiler.phase("h_oneprog"):
            use_c = use_cosets and vm_prog_coset is not None
            prog = vm_prog_coset if use_c else vm_prog
            jit_fn = h_coset_jit if use_c else h_all_jit
            dims = (inputs["advice"].shape[1], inputs["instance"].shape[1],
                    inputs["z"].shape[1], inputs["lookups"].shape[1],
                    res_omegas["l2c"],
                    res_omegas["n_fwd"] if use_c else res_omegas["c2e"],
                    res_omegas["e2c"], prog.n_reg, prog.out_reg)
            if use_c:
                dims = dims + ("coset",)
            cn = dict(consts)
            cn["ifft_div"] = ifft_div
            cn["ext_ifft_div"] = ext_ifft_div
            # instrs is a per-pk constant: ship it once per process and
            # reuse the device handle (one fewer upload round trip/prove)
            instrs_dev = instrs_memo.get(id(prog))
            if instrs_dev is None:
                instrs_dev = instrs_memo[id(prog)] = jnp.asarray(prog.instrs)
            profiler.count("rt_h_upload", 1)      # scal_np ships per prove
            args = (inputs["advice"], inputs["instance"], inputs["z"],
                    inputs["lookups"], inputs["static_b"],
                    inputs["static_f"], jnp.asarray(scal_np),
                    instrs_dev, cn, plans, dims)
            if _os2.environ.get("SHA2CQ_H_LOWER_DEBUG"):
                # persistent-cache-key diagnosis: hash the lowered module and
                # jax's own cache key; any run-to-run difference here is a
                # forced recompile of the fused program
                import hashlib
                low = h_all_jit.lower(*args)
                txt = low.as_text()
                print("[h_all lower] hlo sha256",
                      hashlib.sha256(txt.encode()).hexdigest()[:16],
                      len(txt), flush=True)
                dump = _os2.environ.get("SHA2CQ_H_LOWER_DUMP")
                if dump:
                    with open(dump, "w") as f:
                        f.write(txt)
                try:
                    from jax._src import cache_key as _ck
                    from jax._src import compiler as _comp
                    backend = jax.devices()[0].client
                    opts = _comp.get_compile_options(1, 1)
                    print("[h_all lower] jax cache key",
                          _ck.get(low._lowering.stablehlo(), opts, backend)[:16],
                          flush=True)
                except Exception as e:
                    print("[h_all lower] cache key unavailable:",
                          repr(e)[:80], flush=True)
                if _os2.environ.get("SHA2CQ_H_LOWER_ONLY"):
                    # diagnosis mode: stop before the (minutes-long cold)
                    # compile so two processes' keys can be compared cheaply
                    raise RuntimeError("SHA2CQ_H_LOWER_ONLY")
            exe = _aot_executable(args, jit_fn)
            with profiler.phase("dispatch"):
                profiler.count("rt_h_dispatch", 1)
                if exe is not None:
                    try:
                        # block inside the try: a blob can also fail at run
                        # time (XLA:CPU blobs serialized from an executable
                        # that JAX's persistent cache supplied lack functions)
                        h_dev, adv_coeff = jax.block_until_ready(
                            exe(*args[:10]))
                    except Exception as e:
                        # stale/incompatible blob: drop it, recompile once
                        print(f"[h_all aot] dispatch failed, recompiling: "
                              f"{e!r:.120}", flush=True)
                        bad = aot_memo.get("loaded_from")
                        if bad:
                            try:
                                _os2.remove(bad)
                            except OSError:
                                pass
                        aot_memo.clear()
                        aot_memo["failed"] = True
                        h_dev, adv_coeff = jit_fn(*args)
                else:
                    h_dev, adv_coeff = jit_fn(*args)
                jax.block_until_ready(h_dev)
        return h_dev, adv_coeff

    def run(inputs):
        from ..utils.profiling import profiler
        eager = use_mxu and not is_multidevice(inputs["advice"])
        if use_oneprog and eager and "scalars_raw" in inputs:
            return run_oneprog(inputs)
        inputs = {k: v for k, v in inputs.items() if k != "scalars_raw"}
        if "static" not in inputs:
            # fallback paths consume the merged [b0, f0, ...] stack
            sb = inputs.pop("static_b")
            sf = inputs.pop("static_f")
            inputs["static"] = jnp.stack([sb, sf], axis=2).reshape(
                NLIMB, 2 * sb.shape[1], sb.shape[2])
        if inputs["advice"].dtype != D.U32:
            inputs = {k: (v.astype(D.U32) if hasattr(v, "dtype") and
                          v.dtype == jnp.uint16 else v)
                      for k, v in inputs.items()}
        with profiler.phase("h_convert"):
            state = (convert_eager(inputs) if eager
                     else convert_jit(inputs, plans, consts))
            jax.block_until_ready(state["advice"])
        advice_coeff = state.pop("advice_coeff")
        sc = inputs["scalars"]
        with profiler.phase("h_chunks"):
            if vm_prog is not None and is_multidevice(inputs["advice"]):
                from . import h_vm as _h_vm
                mesh_ = inputs["advice"].sharding.mesh
                values = _h_vm.run_program_sharded(
                    vm_prog, state, consts, sc, size, mesh_)
                # replicate before the quotient piece: its row-axis iNTT
                # under GSPMD partitioning is exactly the 12-min slow path
                # the VM exists to avoid, and (16, size) is a few MB
                values = jax.device_put(
                    values, jax.sharding.NamedSharding(
                        mesh_, jax.sharding.PartitionSpec()))
            elif vm_prog is not None:
                from . import h_vm as _h_vm
                values = _h_vm.run_program(vm_prog, state, consts, sc, size)
            else:
                values = D.zeros((size,), FR)
                for g in ensure_chunk_jits():
                    values = g(values, state, sc, consts)
            jax.block_until_ready(values)
        with profiler.phase("h_quotient"):
            out = (quotient_eager(values) if eager
                   else quotient_jit(values, consts, plans))
            jax.block_until_ready(out)
        return out, advice_coeff

    def prewarm():
        """Deserialize (or compile+cache) the fused h executable ahead of the
        witness: the arg SHAPES are fully determined by the proving key, so a
        background thread can pay the AOT load while the prover's native
        witness/commitment/CQ phases run (create_proof spawns one).  No-op
        when the one-program path is off."""
        if not use_oneprog:
            return
        import numpy as np
        n = domain.n
        Ca = cs.num_advice_columns
        Ci = cs.num_instance_columns
        Cz = num_sets
        Cl = 3 * len(cs.lookups)
        Cst = 2 * len(cs.static_lookups)

        def z16(c):
            return jnp.zeros((NLIMB, c, n), dtype=jnp.uint16)

        n_scal = 4 + cs.num_challenges + len(vm_prog.const_scalars)
        scal = jnp.asarray(D.np_pack([0] * n_scal, FR))
        use_c = use_cosets and vm_prog_coset is not None
        prog = vm_prog_coset if use_c else vm_prog
        jit_fn = h_coset_jit if use_c else h_all_jit
        dims = (Ca, Ci, Cz, Cl, res_omegas["l2c"],
                res_omegas["n_fwd"] if use_c else res_omegas["c2e"],
                res_omegas["e2c"], prog.n_reg, prog.out_reg)
        if use_c:
            dims = dims + ("coset",)
        cn = dict(consts)
        cn["ifft_div"] = ifft_div
        cn["ext_ifft_div"] = ext_ifft_div
        nq = Cst // 2
        args = (z16(Ca), z16(Ci), z16(Cz), z16(Cl), z16(nq), z16(nq), scal,
                jnp.asarray(prog.instrs), cn, plans, dims)
        exe = _aot_executable(args, jit_fn)
        if (exe is not None and not aot_memo.get(("preloaded", id(exe)))
                and _os2.environ.get("SHA2CQ_H_PRELOAD", "1") == "1"):
            aot_memo[("preloaded", id(exe))] = True
            # dispatch once on the zero inputs and drain with a 1-element
            # fetch: the first execution pays the program load onto the
            # device — forcing it here keeps that cost on the prefetch
            # thread instead of the prover's first h dispatch
            try:
                out = exe(*args[:10])
                jax.device_get(out[0][:1, :1])
            except Exception as e:
                print(f"[h prewarm] preload dispatch failed: {e!r:.120}",
                      flush=True)

    run.prewarm = prewarm
    return run


def get_h_fn(pk, use_mxu: Optional[bool] = None):
    key = "_h_fn_mxu" if use_mxu else "_h_fn" if use_mxu is False else "_h_fn_auto"
    fn = getattr(pk, key, None)
    if fn is None:
        fn = build_h_fn(pk, use_mxu=use_mxu)
        setattr(pk, key, fn)
    return fn


def stack_columns(cols, n, sharding=None, ndev=1):
    """Pack a list of columns (int lists or canonical (n,4) u64 limb
    buffers) into the h-input device layout (16, C, n) and START the
    host->device transfer (jnp.asarray is asynchronous).  Exposed so the
    prover can stage the advice/instance stacks right after the witness
    phase — the ~26 MB transfer overlaps the native CQ/permutation phases
    (see create_proof)."""
    import numpy as np
    dt = np.uint16 if sharding is None else np.uint32
    if not cols:
        out = jnp.zeros((NLIMB, 0, n), dtype=dt)
    else:
        if all(isinstance(c, np.ndarray) for c in cols):
            packed = D.np_pack_buf(np.concatenate(cols), FR)
        else:
            from ..poly.arith import as_coeff_list
            flat = [v for c in (as_coeff_list(c) for c in cols) for v in c]
            packed = D.np_pack(flat, FR)
        out = jnp.asarray(packed.reshape(NLIMB, len(cols), n).astype(dt))
    if sharding is not None:
        # pad the column axis to a multiple of the mesh size (consumers
        # index columns by position, so zero columns at the end are inert)
        pad = (-out.shape[1]) % ndev
        if pad:
            out = jnp.concatenate(
                [out, jnp.zeros((NLIMB, pad, n), dtype=D.U32)], axis=1)
        out = jax.device_put(out, sharding)
    return out


def prepare_h_inputs(pk, advice_values, instance_values, challenges, y, beta,
                     gamma, theta, lookups, static_lookups, permutations,
                     mesh=None, staged: Optional[Dict] = None) -> Dict:
    """Pack per-proof witness state into the h_fn input pytree (host->device
    transfer happens once here).

    With a mesh, the (16, C, n) column stacks are placed sharded over the
    COLUMN axis (jax.sharding.NamedSharding) — jit then partitions the whole
    fused h computation across the mesh.  Column sharding keeps every NTT
    device-local (GSPMD partitioning of the butterfly gathers over the row
    axis measured 12+ minutes of compile) and matches the reference's
    per-column rayon parallelism (SURVEY §2.4); collectives appear only at
    the y-fold accumulation joins."""
    import numpy as np
    n = pk.vk.domain.n
    cs = pk.vk.cs

    sharding = None
    ndev = 1
    if mesh is not None:
        from jax.sharding import NamedSharding, PartitionSpec
        sharding = NamedSharding(mesh, PartitionSpec(None, "x", None))
        ndev = mesh.devices.size

    def stack(cols):
        # single-device stacks ship as uint16 (the limbs are canonical
        # 16-bit values): halves the host->device bytes; the fused h program
        # widens them on device.  One native pack + ONE host->device
        # transfer per stack (not one per column plus a device concat).
        return stack_columns(cols, n, sharding=sharding, ndev=ndev)

    z_cols = [s["lagrange"] for s in (permutations[0]["sets"] if permutations else [])]
    lk_cols = []
    for lk in (lookups[0] if lookups else []):
        lk_cols.extend([lk["product_lagrange"], lk["permuted_input"],
                        lk["permuted_table"]])
    st_b_cols = [sl["b"] for sl in (static_lookups[0] if static_lookups
                                    else [])]
    st_f_cols = [sl["f"] for sl in (static_lookups[0] if static_lookups
                                    else [])]

    ch = (jnp.asarray(D.np_pack(list(challenges), FR)
                      .reshape(NLIMB, len(challenges), 1))
          if challenges else jnp.zeros((NLIMB, 0, 1), dtype=D.U32))
    staged = staged or {}
    out = {
        "advice": (staged["advice"] if "advice" in staged
                   else stack(advice_values[0])),
        "instance": (staged["instance"] if "instance" in staged
                     else stack(instance_values[0])),
        "z": stack(z_cols),
        "lookups": stack(lk_cols),
        "scalars": {
            "y": _const(y), "beta": _const(beta), "gamma": _const(gamma),
            "theta": _const(theta), "challenges": ch,
        },
        # host ints for the one-program path (device_eval.run_oneprog packs
        # the VM scalar table in numpy — no per-scalar device programs)
        "scalars_raw": {
            "y": y, "beta": beta, "gamma": gamma, "theta": theta,
            "challenges": list(challenges),
        },
    }
    if mesh is not None:
        # the mesh path consumes the merged [b0, f0, ...] stack directly
        st_cols = [c for pair in zip(st_b_cols, st_f_cols) for c in pair]
        out["static"] = stack(st_cols)
    else:
        out["static_b"] = stack(st_b_cols)
        out["static_f"] = (staged["static_f"] if "static_f" in staged
                           else stack(st_f_cols))
    return out
