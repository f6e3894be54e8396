"""Scanned bytecode VM for the h-polynomial fold (prover hot loop #1).

Why a VM: the chunked term-fold in plonk/device_eval.py builds ~20 jitted
graphs of ~100 field ops each; with the 16-limb mont_mul expanding to >10^3
HLO ops, every graph is a 10^5-node XLA module, and per-process trace/lower/
compile work for those graphs dwarfed their millisecond execution.

This module is the device analogue of the reference's GraphEvaluator
(halo2_proofs/src/plonk/evaluation.rs:176-282): the constraint fold is
compiled ONCE, host-side, to a linear instruction stream over a register
file, with common-subexpression elimination (evaluation.rs's
ValueSource/Calculation dedup) and last-use register reuse.  On device the
whole fold is ONE `lax.scan` over the instruction array whose body is a
single `lax.switch` over ~16 field primitives — a few-thousand-node XLA
graph that compiles in seconds and is shared by every circuit with the same
instruction/register/column counts.

Execution cost: one (16, n_ext) mont_mul/add/sub per instruction, all
device-resident; the register file is a (16, NREG, n_ext) carry updated in
place via dynamic_update_index (donated, so XLA aliases the buffer).

Semantics are EXACTLY the device_eval chunk fold (same y-fold order as host
evaluate_h / reference evaluation.rs:285-551): proofs stay byte-identical —
pinned in tests/test_device_prover.py.
"""
from __future__ import annotations

import functools
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..fields import device as D
from ..fields import host as H
from ..fields.device import FR, NLIMB, U32

P = H.FR_MOD

# opcodes ---------------------------------------------------------------------
LOAD_ADVICE, LOAD_INSTANCE, LOAD_FIXED, LOAD_SIGMA = 0, 1, 2, 3
LOAD_Z, LOAD_LK, LOAD_ST, LOAD_AUX = 4, 5, 6, 7
LOADS = 8            # dst <- broadcast scalar S[b]
ADD, SUB, MUL = 9, 10, 11          # dst <- r[a] (op) r[b]
ADDS, SUBS, MULS = 12, 13, 14      # dst <- r[a] (op) S[b]
SUBS_R = 15                        # dst <- S[b] - r[a]
N_OPS = 16

# aux column slots (group LOAD_AUX)
AUX_L0, AUX_L_LAST, AUX_L_ACTIVE, AUX_ZTC = 0, 1, 2, 3

_LOAD_OPS = frozenset(range(8))


class Program(NamedTuple):
    """Host-assembled h-fold program (device arrays built per pk)."""
    instrs: np.ndarray          # (N, 4) int32: op, a, b, dst
    n_reg: int
    out_reg: int
    const_scalars: List[int]    # appended after runtime scalar slots
    n_runtime: int              # y,beta,gamma,theta + challenges


class _Asm:
    """SSA assembler with CSE; finalized by linear-scan register allocation.

    Values are ('r', ssa_id) or ('s', scalar_idx); scalar-scalar arithmetic
    materializes one operand with LOADS (runtime scalars can't be folded
    host-side).  Mirrors the reference GraphEvaluator's ValueSource dedup
    (evaluation.rs:63-174)."""

    def __init__(self, n_runtime: int):
        self.instrs: List[Tuple[int, int, int]] = []   # SSA: dst == index
        self._cse: Dict[tuple, int] = {}
        self.n_runtime = n_runtime
        self.consts: List[int] = []
        self._cidx: Dict[int, int] = {}

    # -- scalars
    def sconst(self, v: int) -> Tuple[str, int]:
        v %= P
        if v not in self._cidx:
            self._cidx[v] = self.n_runtime + len(self.consts)
            self.consts.append(v)
        return ("s", self._cidx[v])

    # -- raw emit with CSE
    def _emit(self, op: int, a: int, b: int, key: Optional[tuple]) -> int:
        if key is not None and key in self._cse:
            return self._cse[key]
        self.instrs.append((op, a, b))
        rid = len(self.instrs) - 1
        if key is not None:
            self._cse[key] = rid
        return rid

    # -- loads
    def load(self, op: int, col: int, shift: int) -> Tuple[str, int]:
        return ("r", self._emit(op, col, shift, (op, col, shift)))

    def _as_reg(self, v) -> int:
        if v[0] == "r":
            return v[1]
        return self._emit(LOADS, 0, v[1], (LOADS, v[1]))

    # -- arithmetic on ('r'|'s', idx) operands
    def add(self, x, y):
        if x[0] == "s" and y[0] == "s":
            x = ("r", self._as_reg(x))
        if x[0] == "s":
            x, y = y, x
        if y[0] == "s":
            return ("r", self._emit(ADDS, x[1], y[1], (ADDS, x[1], y[1])))
        a, b = sorted((x[1], y[1]))
        return ("r", self._emit(ADD, a, b, (ADD, a, b)))

    def mul(self, x, y):
        if x[0] == "s" and y[0] == "s":
            x = ("r", self._as_reg(x))
        if x[0] == "s":
            x, y = y, x
        if y[0] == "s":
            return ("r", self._emit(MULS, x[1], y[1], (MULS, x[1], y[1])))
        a, b = sorted((x[1], y[1]))
        return ("r", self._emit(MUL, a, b, (MUL, a, b)))

    def sub(self, x, y):
        if y[0] == "s":
            x = ("r", self._as_reg(x)) if x[0] == "s" else x
            return ("r", self._emit(SUBS, x[1], y[1], (SUBS, x[1], y[1])))
        if x[0] == "s":
            return ("r", self._emit(SUBS_R, y[1], x[1], (SUBS_R, y[1], x[1])))
        return ("r", self._emit(SUB, x[1], y[1], (SUB, x[1], y[1])))

    def neg(self, x):
        return self.sub(self.sconst(0), x)

    # -- finalize
    def finish(self, out) -> Program:
        out_ssa = self._as_reg(out)
        n = len(self.instrs)
        last_use = [-1] * n
        for i, (op, a, b) in enumerate(self.instrs):
            if op in _LOAD_OPS or op == LOADS:
                continue
            last_use[a] = i
            if op in (ADD, SUB, MUL):
                last_use[b] = i
        last_use[out_ssa] = n  # result stays live
        phys = [-1] * n
        free: List[int] = []
        n_reg = 0
        final = np.zeros((n, 4), dtype=np.int32)
        for i, (op, a, b) in enumerate(self.instrs):
            if op in _LOAD_OPS or op == LOADS:
                pa, pb = a, b
            elif op in (ADD, SUB, MUL):
                pa, pb = phys[a], phys[b]
            else:
                pa, pb = phys[a], b
            # free operands whose last use is here (dst may reuse them)
            if op not in _LOAD_OPS and op != LOADS:
                if last_use[a] == i:
                    free.append(phys[a])
                if op in (ADD, SUB, MUL) and last_use[b] == i and phys[b] not in free:
                    free.append(phys[b])
            if free:
                pd = free.pop()
            else:
                pd = n_reg
                n_reg += 1
            phys[i] = pd
            final[i] = (op, pa, pb, pd)
        return Program(instrs=final, n_reg=max(n_reg, 1),
                       out_reg=phys[out_ssa],
                       const_scalars=list(self.consts),
                       n_runtime=self.n_runtime)


# ----------------------------- program assembly ------------------------------

def program_y_fold_count(pk) -> int:
    """Number of y-Horner folds the h program performs for ONE circuit —
    each `fold` below multiplies the whole accumulator by y exactly once, so
    a multi-circuit proof combines per-circuit quotients as
    h = sum_c h_c * y^{T*(nc-1-c)} (the prover's circuit-major accumulation,
    reference evaluation.rs:285-374).  Must mirror assemble_h_program's (and
    evaluate_h's) term emission exactly."""
    cs = pk.vk.cs
    t = sum(len(g.polys) for g in cs.gates)
    columns = cs.permutation.columns
    chunk_len = max(pk.vk.cs_degree - 2, 1)
    num_sets = (len(columns) + chunk_len - 1) // chunk_len if columns else 0
    if num_sets:
        t += 2 + (num_sets - 1) + num_sets
    t += 5 * len(cs.lookups)
    t += len(cs.static_lookups)
    return t


def assemble_h_program(pk, rot_scale: "int | None" = None) -> Program:
    """Compile pk's constraint system into a VM program.  Term order matches
    plonk/device_eval.build_h_fn exactly (gates, permutation head/boundaries/
    sets, dynamic lookups, CQ static lookups — the host evaluate_h order), so
    resulting h values — and proofs — are identical.

    rot_scale: roll step per base-domain rotation.  Default = ext/n (the
    program runs over the full extended coset).  The coset-streamed h path
    (device_eval, SHA2CQ_H_COSETS) passes 1: each of the ext/n cosets is a
    rotation-closed n-row slice, so base rotations roll by exactly one row
    within it."""
    cs = pk.vk.cs
    domain = pk.vk.domain
    if rot_scale is None:
        rot_scale = 1 << (domain.extended_k - domain.k)
    n_runtime = 4 + cs.num_challenges
    A = _Asm(n_runtime)
    Y, BETA, GAMMA, THETA = ("s", 0), ("s", 1), ("s", 2), ("s", 3)
    ONE = A.sconst(1)

    def shift(rot: int) -> int:
        return -rot * rot_scale

    def chal(idx: int):
        return ("s", 4 + idx)

    def eval_expr(expr):
        return expr.evaluate({
            "const": lambda v: A.sconst(v),
            "selector": lambda e: (_ for _ in ()).throw(ValueError("selector")),
            "fixed": lambda e: A.load(LOAD_FIXED, e.column.index, shift(e.rotation)),
            "advice": lambda e: A.load(LOAD_ADVICE, e.column.index, shift(e.rotation)),
            "instance": lambda e: A.load(LOAD_INSTANCE, e.column.index, shift(e.rotation)),
            "challenge": lambda e: chal(e.value),
            "neg": lambda a: A.neg(a),
            "sum": lambda a, b: A.add(a, b),
            "prod": lambda a, b: A.mul(a, b),
            "scaled": lambda a, v: A.mul(a, A.sconst(v)),
        })

    values = A.sconst(0)

    def fold(acc, term):
        return A.add(A.mul(acc, Y), term)

    def col_val(column, sh=0):
        if column.kind == "advice":
            return A.load(LOAD_ADVICE, column.index, sh)
        if column.kind == "fixed":
            return A.load(LOAD_FIXED, column.index, sh)
        return A.load(LOAD_INSTANCE, column.index, sh)

    l0 = lambda: A.load(LOAD_AUX, AUX_L0, 0)
    l_last = lambda: A.load(LOAD_AUX, AUX_L_LAST, 0)
    l_active = lambda: A.load(LOAD_AUX, AUX_L_ACTIVE, 0)

    # gates
    for gate in cs.gates:
        for poly in gate.polys:
            values = fold(values, eval_expr(poly))

    # permutation argument (device_eval emit_perm_* order)
    bf = cs.blinding_factors()
    chunk_len = max(pk.vk.cs_degree - 2, 1)
    columns = cs.permutation.columns
    num_sets = (len(columns) + chunk_len - 1) // chunk_len if columns else 0
    if num_sets:
        first = A.load(LOAD_Z, 0, 0)
        last = A.load(LOAD_Z, num_sets - 1, 0)
        values = fold(values, A.mul(A.sub(ONE, first), l0()))
        values = fold(values, A.mul(
            A.sub(A.mul(last, last), last), l_last()))
        for i in range(1, num_sets):
            term = A.sub(A.load(LOAD_Z, i, 0),
                         A.load(LOAD_Z, i - 1, shift(-(bf + 1))))
            values = fold(values, A.mul(term, l0()))
        for ci in range(num_sets):
            z = A.load(LOAD_Z, ci, 0)
            cols = columns[ci * chunk_len:(ci + 1) * chunk_len]
            left = A.load(LOAD_Z, ci, shift(1))
            for j, column in enumerate(cols):
                sigma = A.load(LOAD_SIGMA, ci * chunk_len + j, 0)
                vals = col_val(column)
                left = A.mul(left, A.add(
                    A.add(vals, A.mul(BETA, sigma)), GAMMA))
            right = z
            delta_pow = pow(H.FR_DELTA, ci * chunk_len, P)
            cur_delta = A.mul(A.mul(A.load(LOAD_AUX, AUX_ZTC, 0), BETA),
                              A.sconst(delta_pow))
            for column in cols:
                vals = col_val(column)
                right = A.mul(right, A.add(A.add(vals, cur_delta), GAMMA))
                cur_delta = A.mul(cur_delta, A.sconst(H.FR_DELTA))
            values = fold(values, A.mul(A.sub(left, right), l_active()))

    # dynamic lookups (device_eval emit_lookup order)
    for n_lk, arg in enumerate(cs.lookups):
        product = A.load(LOAD_LK, 3 * n_lk, 0)
        inp = A.load(LOAD_LK, 3 * n_lk + 1, 0)
        tab = A.load(LOAD_LK, 3 * n_lk + 2, 0)
        comp_in = A.sconst(0)
        for e in arg.input_expressions:
            comp_in = A.add(A.mul(comp_in, THETA), eval_expr(e))
        comp_tab = A.sconst(0)
        for e in arg.table_expressions:
            comp_tab = A.add(A.mul(comp_tab, THETA), eval_expr(e))
        a_minus_s = A.sub(inp, tab)
        values = fold(values, A.mul(A.sub(ONE, product), l0()))
        values = fold(values, A.mul(
            A.sub(A.mul(product, product), product), l_last()))
        table_value = A.mul(A.add(comp_in, BETA), A.add(comp_tab, GAMMA))
        left = A.mul(A.mul(A.load(LOAD_LK, 3 * n_lk, shift(1)),
                           A.add(inp, BETA)), A.add(tab, GAMMA))
        values = fold(values, A.mul(
            A.sub(left, A.mul(product, table_value)), l_active()))
        values = fold(values, A.mul(a_minus_s, l0()))
        values = fold(values, A.mul(
            A.mul(a_minus_s, A.sub(inp, A.load(LOAD_LK, 3 * n_lk + 1, shift(-1)))),
            l_active()))

    # CQ static lookups (device_eval emit_cq order); zk mode gates the term
    # by l_active (static_lookup.py module docstring)
    for i in range(len(cs.static_lookups)):
        b_coset = A.load(LOAD_ST, 2 * i, 0)
        f_coset = A.load(LOAD_ST, 2 * i + 1, 0)
        if getattr(cs, "zk_static_lookups", False):
            term = A.mul(b_coset, A.add(f_coset, BETA))
            values = fold(values, A.mul(A.sub(term, ONE), l_active()))
        else:
            term = A.mul(b_coset, A.add(A.mul(f_coset, l_active()), BETA))
            values = fold(values, A.sub(term, ONE))

    return A.finish(values)


# ------------------------------- device kernel -------------------------------

def _vm_scan(instrs, regs, groups, scal):
    """Trace-level VM executor (no jit wrapper): callable from enclosing
    programs (device_eval h_all_fn fuses convert + VM + quotient into ONE
    executable).  regs (16, NREG, n)
    carry; groups a dict of (16, C, n) column arrays; scal (16, NS)."""
    def step(regs, ins):
        op, a, b, dst = ins[0], ins[1], ins[2], ins[3]

        def rd(i):
            return jax.lax.dynamic_index_in_dim(regs, i, axis=1,
                                                keepdims=False)

        def sc(i):
            return jax.lax.dynamic_index_in_dim(scal, i, axis=1,
                                                keepdims=True)

        def ld(name):
            def f():
                # groups may be stored as uint16 (canonical limbs) to halve
                # their device footprint; widen per loaded column (no-op for
                # u32, fused into the roll for u16)
                col = jax.lax.dynamic_index_in_dim(groups[name], a, axis=1,
                                                   keepdims=False).astype(U32)
                return jnp.roll(col, b, axis=1)
            return f

        branches = [
            ld("advice"), ld("instance"), ld("fixed"), ld("sigma"),
            ld("z"), ld("lk"), ld("st"), ld("aux"),
            lambda: jnp.broadcast_to(sc(b), regs.shape[:1] + regs.shape[2:]),
            lambda: D.add(rd(a), rd(b), FR),
            lambda: D.sub(rd(a), rd(b), FR),
            lambda: D.mont_mul(rd(a), rd(b), FR),
            lambda: D.add(rd(a), jnp.broadcast_to(
                sc(b), regs.shape[:1] + regs.shape[2:]), FR),
            lambda: D.sub(rd(a), jnp.broadcast_to(
                sc(b), regs.shape[:1] + regs.shape[2:]), FR),
            lambda: D.mont_mul(rd(a), sc(b), FR),
            lambda: D.sub(jnp.broadcast_to(
                sc(b), regs.shape[:1] + regs.shape[2:]), rd(a), FR),
        ]
        out = jax.lax.switch(op, branches)
        regs = jax.lax.dynamic_update_index_in_dim(regs, out, dst, axis=1)
        return regs, None

    regs, _ = jax.lax.scan(step, regs, instrs)
    return regs


@functools.partial(jax.jit, donate_argnums=(1,))
def _vm_run(instrs, regs, groups, scal):
    """Standalone jitted VM dispatch (run_program); the fused h program
    calls _vm_scan directly instead."""
    return _vm_scan(instrs, regs, groups, scal)


def _program_max_shift(prog: Program) -> int:
    """Largest |roll shift| any load performs (rows of halo a shard needs)."""
    s = 0
    for op, a, b, dst in prog.instrs:
        if op in _LOAD_OPS:
            s = max(s, abs(int(b)))
    return s


def build_sharded_vm(prog: Program, mesh, size: int):
    """shard_map formulation of the VM over the extended-domain ROW axis.

    Why: GSPMD partitioning of the fused h graphs measured 12+ minutes of
    XLA-CPU compile (ROADMAP round-2 item 11), and the single-device VM's
    per-instruction dynamic column index would become a cross-device gather
    under a column-sharded GSPMD jit.  Row sharding makes every VM
    instruction embarrassingly parallel EXCEPT the rotation rolls — and all
    rotations are bounded by S = max|shift| (a few multiples of
    rot_scale = 2^(extended_k - k), far below the shard size).  So each
    column group is halo-extended ONCE up front (one ppermute per direction,
    wrapping, matching jnp.roll's mod-N semantics) and every in-scan load
    becomes a LOCAL dynamic_slice of the extended column at offset S - shift.
    The scan body then contains no collectives at all: compile time is the
    single-device VM's (~seconds), independent of mesh size.

    Returns fn(regs0, groups, scal) -> regs with groups row-sharded
    (16, C, size) arrays; caller places inputs with NamedSharding
    (None, None, "x") and reads back the (16, NREG, size) result.
    """
    from jax.sharding import NamedSharding, PartitionSpec as PSpec

    nd = mesh.devices.size
    m = size // nd
    S = _program_max_shift(prog)
    # multi-axis meshes (e.g. ("y","x") = DCN hosts x ICI chips) shard the
    # row axis over the FLATTENED axes; ppermute over the tuple addresses
    # the flat lexicographic device index, so neighbor halo traffic stays
    # on the fastest (last) axis except at outer-axis boundaries
    axes = tuple(mesh.axis_names)
    ax = axes if len(axes) > 1 else axes[0]
    fwd = [(i, (i + 1) % nd) for i in range(nd)]
    bwd = [(i, (i - 1) % nd) for i in range(nd)]
    instrs = jnp.asarray(prog.instrs)

    def halo(col):
        # col (16, C, m) -> (16, C, m + 2S): [S rows ending at my global
        # start | col | S rows from my global end], wrapping mod N like
        # jnp.roll.  Production shards have S << m (one S-row edge exchange
        # each way); tiny test domains may need whole neighbor blocks
        # (p = ceil(S/m) ppermute hops), trimmed back to exactly S.
        if S == 0:
            return col
        if S < m:
            prev = jax.lax.ppermute(col[..., -S:], ax, fwd)
            nxt = jax.lax.ppermute(col[..., :S], ax, bwd)
            return jnp.concatenate([prev, col, nxt], axis=-1)
        p = -(-S // m)
        parts_prev, parts_next = [], []
        cur_prev = cur_next = col
        for _ in range(p):
            cur_prev = jax.lax.ppermute(cur_prev, ax, fwd)
            parts_prev.insert(0, cur_prev)
            cur_next = jax.lax.ppermute(cur_next, ax, bwd)
            parts_next.append(cur_next)
        ext = jnp.concatenate(parts_prev + [col] + parts_next, axis=-1)
        return ext[..., p * m - S: p * m + m + S]

    def local_run(regs, groups, scal):
        # the scalar table is replicated (unvarying over mesh axis "x");
        # mix in a zero from the varying regs so every switch branch and the
        # scan carry share one varying-manual-axes type
        scal = scal + (regs[:, 0, :1] & jnp.uint32(0))
        ext = {k: halo(v) for k, v in groups.items()}

        def step(regs, ins):
            op, a, b, dst = ins[0], ins[1], ins[2], ins[3]

            def rd(i):
                return jax.lax.dynamic_index_in_dim(regs, i, axis=1,
                                                    keepdims=False)

            def sc(i):
                return jax.lax.dynamic_index_in_dim(scal, i, axis=1,
                                                    keepdims=True)

            def ld(name):
                def f():
                    col = jax.lax.dynamic_index_in_dim(
                        ext[name], a, axis=1, keepdims=False).astype(U32)
                    if S == 0:
                        return col
                    return jax.lax.dynamic_slice_in_dim(col, S - b, m, axis=1)
                return f

            bshape = regs.shape[:1] + regs.shape[2:]
            branches = [
                ld("advice"), ld("instance"), ld("fixed"), ld("sigma"),
                ld("z"), ld("lk"), ld("st"), ld("aux"),
                lambda: jnp.broadcast_to(sc(b), bshape),
                lambda: D.add(rd(a), rd(b), FR),
                lambda: D.sub(rd(a), rd(b), FR),
                lambda: D.mont_mul(rd(a), rd(b), FR),
                lambda: D.add(rd(a), jnp.broadcast_to(sc(b), bshape), FR),
                lambda: D.sub(rd(a), jnp.broadcast_to(sc(b), bshape), FR),
                lambda: D.mont_mul(rd(a), sc(b), FR),
                lambda: D.sub(jnp.broadcast_to(sc(b), bshape), rd(a), FR),
            ]
            out = jax.lax.switch(op, branches)
            regs = jax.lax.dynamic_update_index_in_dim(regs, out, dst, axis=1)
            return regs, None

        regs, _ = jax.lax.scan(step, regs, instrs)
        return regs

    row = PSpec(None, None, axes if len(axes) > 1 else axes[0])
    mapped = jax.shard_map(
        local_run, mesh=mesh,
        in_specs=(row, {k: row for k in
                        ("advice", "instance", "fixed", "sigma",
                         "z", "lk", "st", "aux")}, PSpec()),
        out_specs=row)
    return jax.jit(mapped, donate_argnums=(0,))


def run_program_sharded(prog: Program, state: Dict, consts: Dict,
                        scalars: Dict, size: int, mesh) -> jnp.ndarray:
    """Mesh-sharded VM execution; same inputs/result as run_program but with
    the row axis sharded over mesh axis "x" (resharding column-sharded
    convert_fn outputs via device_put's all_to_all)."""
    from jax.sharding import NamedSharding, PartitionSpec as PSpec

    cache = build_sharded_vm.__dict__.setdefault("_cache", {})
    key = (id(prog), id(mesh), size)
    vm = cache.get(key)
    if vm is None:
        vm = build_sharded_vm(prog, mesh, size)
        cache[key] = vm

    axes = tuple(mesh.axis_names)
    row = NamedSharding(mesh, PSpec(None, None,
                                    axes if len(axes) > 1 else axes[0]))
    groups, rt_scal = _build_groups(prog, state, consts, scalars, size)
    groups = {k: jax.device_put(v, row) for k, v in groups.items()}
    regs0 = jax.device_put(
        jnp.zeros((NLIMB, prog.n_reg, size), dtype=U32), row)
    regs = vm(regs0, groups, rt_scal)
    return regs[:, prog.out_reg]


def _build_groups(prog: Program, state: Dict, consts: Dict, scalars: Dict,
                  size: int):
    """Shared packing of the VM's column groups + scalar table."""
    def pad1(a):
        if a.shape[1]:
            return a
        return jnp.zeros((NLIMB, 1, size), dtype=U32)

    aux = jnp.stack([consts["l0"], consts["l_last"], consts["l_active"],
                     consts["zeta_times_coset"]], axis=1)
    groups = {
        "advice": pad1(state["advice"]),
        "instance": pad1(state["instance"]),
        "fixed": pad1(consts["fixed"]),
        "sigma": pad1(consts["sigma"]),
        "z": pad1(state["z"]),
        "lk": pad1(state["lk"]),
        "st": pad1(state["st"]),
        "aux": aux,
    }
    rt = jnp.stack([scalars["y"][:, 0], scalars["beta"][:, 0],
                    scalars["gamma"][:, 0], scalars["theta"][:, 0]],
                   axis=1)                          # (16, 4)
    ch = scalars["challenges"][:, :, 0] if scalars["challenges"].shape[1] \
        else jnp.zeros((NLIMB, 0), dtype=U32)
    cst = (jnp.asarray(D.np_pack(prog.const_scalars, FR))
           if prog.const_scalars else jnp.zeros((NLIMB, 0), dtype=U32))
    scal = jnp.concatenate([rt, ch, cst], axis=1)
    return groups, scal


def run_program(prog: Program, state: Dict, consts: Dict, scalars: Dict,
                size: int) -> jnp.ndarray:
    """Evaluate the program against converted coset state (from
    device_eval.convert_fn) + per-pk consts; returns the (16, size) h values
    (pre-quotient)."""
    groups, scal = _build_groups(prog, state, consts, scalars, size)
    regs0 = jnp.zeros((NLIMB, prog.n_reg, size), dtype=U32)
    regs = _vm_run(jnp.asarray(prog.instrs), regs0, groups, scal)
    return regs[:, prog.out_reg]
