"""create_proof — the prover pipeline (reference plonk/prover.rs:51-779).

Transcript-ordered phases:
  1. vk hash; instance values absorbed as common scalars
  2. witness synthesis per phase; blind rows; commit advice; phase challenges
  3. theta; dynamic lookups commit_permuted; CQ lookups commit (f, m)
  4. beta, gamma; permutation grand products; lookup products;
     CQ log-derivatives (a, qa, a0, b0, p)
  5. vanishing random commit; y; evaluate_h; h piece commits
  6. x; advice/fixed evals; vanishing eval; permutation common + set evals;
     lookup evals; CQ evals
  7. GWC multiopen over the assembled query set

The extended-domain h evaluation (basis conversions, the constraint fold,
the vanishing quotient) runs on the accelerator whenever the default JAX
backend is not the CPU (`h_device`); commitments, CQ, the permutation and
multiopen run on the host's native kernels.
"""
from __future__ import annotations

import secrets
from typing import List, Optional, Sequence

from ..circuit import SimpleFloorPlanner, Value, planner_for
from ..fields.host import FR_MOD
from ..poly import arith as A
from ..poly.kzg.gwc import ProverQuery, gwc_create_proof
from ..utils.profiling import profiler
from ..utils.transcript import Blake2bWrite
from .circuit_ir import Column, ConstraintSystem, Selector, StaticTableId
from .evaluation import evaluate_h
from .keys import ProvingKey
from .lookup_arg import (lookup_commit_permuted, lookup_commit_product,
                         lookup_evaluate, lookup_open)
from .permutation import (permutation_commit, permutation_evaluate,
                          permutation_open, permutation_pk_evaluate,
                          permutation_pk_open)
from .static_lookup import (static_lookup_commit_all,
                            static_lookup_evaluate, static_lookup_open,
                            static_lookup_log_derivatives_all)
from .vanishing import (vanishing_commit, vanishing_construct,
                        vanishing_evaluate, vanishing_open)

P = FR_MOD


class _SystemRng:
    def randrange(self, n: int) -> int:
        return secrets.randbelow(n)


def _fixed_poly_bufs(pk, n: int):
    """pk.fixed_polys as cached (n, 4) limb buffers (arith.as_coeff_list
    form) — they are opened at x in every proof, so the one-time pack saves
    a per-proof bigint conversion in the eval + multiopen phases."""
    bufs = pk.__dict__.get("_fixed_poly_bufs")
    if bufs is None:
        from ..native_loader import fr_buf, get_lib
        if get_lib() is None or n < 1024:
            bufs = pk.fixed_polys
        else:
            bufs = [fr_buf([c % P for c in poly]) for poly in pk.fixed_polys]
        pk.__dict__["_fixed_poly_bufs"] = bufs
    return bufs


class _WitnessCollection:
    """Assignment sink for witness generation (prover.rs:139-392)."""

    def __init__(self, cs: ConstraintSystem, n: int, usable_rows: int,
                 instances: Sequence[Sequence[int]], current_phase: int,
                 challenges: dict):
        self.cs = cs
        self.n = n
        self.usable_rows = usable_rows
        self.instances = instances
        self.current_phase = current_phase
        self.challenges = challenges
        self.advice = [[0] * n for _ in range(cs.num_advice_columns)]

    def enter_region(self, name):
        pass

    def exit_region(self):
        pass

    def register_static_table(self, table_id: StaticTableId, table):
        pass  # only keygen cares

    def enable_selector(self, selector: Selector, row: int):
        pass

    def query_instance(self, column: Column, row: int) -> Value:
        if row >= self.usable_rows:
            raise ValueError("not enough rows available")
        return Value.known(self.instances[column.index][row])

    def assign_advice(self, column: Column, row: int, value: Value):
        if column.phase != self.current_phase:
            return
        if row >= self.usable_rows:
            raise ValueError("not enough rows available")
        self.advice[column.index][row] = value.assign()

    def assign_advice_slice(self, column: Column, row0: int, values):
        if column.phase != self.current_phase:
            return
        if row0 + len(values) > self.usable_rows:
            raise ValueError("not enough rows available")
        self.advice[column.index][row0:row0 + len(values)] = \
            [v % P for v in values]

    def assign_fixed_slice(self, column: Column, row0: int, values):
        pass

    def assign_fixed(self, column: Column, row: int, value: Value):
        pass

    def copy(self, *args):
        pass

    def fill_from_row(self, *args):
        pass

    def get_challenge(self, challenge) -> Value:
        v = self.challenges.get(challenge.index)
        return Value.known(v) if v is not None else Value.unknown()

    def next_phase(self):
        pass


def prewarm_prover(pk, h_mxu: Optional[bool] = None):
    """Start building/loading the device h pipeline for this proving key on
    a background daemon thread: per-pk consts/plans, the AOT-cached fused
    executable, and one zero-input dispatch that loads it onto the device.
    Idempotent per pk; returns the thread (already-finished threads join
    instantly).  create_proof calls this itself at entry when h runs on the
    device, so the cost overlaps the witness/commitment phases — a service
    that calls it at boot (right after keygen/key load) makes even the
    process's FIRST prove run at the warm rate.  The reference has no
    analogue: its prover is in-process Rust with zero per-process
    compilation (multicore.rs:1-5)."""
    import threading

    th = pk.__dict__.get("_h_prefetch")
    if th is not None:
        return th

    from .device_eval import get_h_fn as _get_h_fn

    def _job():
        try:
            fn = _get_h_fn(pk, use_mxu=h_mxu)
            pw = getattr(fn, "prewarm", None)
            if pw is not None:
                pw()
        except Exception as e:  # prefetch is an optimization only
            print(f"[h prefetch] failed (h path will build inline): "
                  f"{e!r:.120}", flush=True)

    th = threading.Thread(target=_job, daemon=True)
    pk.__dict__["_h_prefetch"] = th
    th.start()
    return th


def default_h_device() -> bool:
    """h runs on the device whenever the default JAX backend is not the
    CPU (the host path is the plain reference; both give identical bytes)."""
    import jax
    return jax.default_backend() != "cpu"


def create_proof(params, pk: ProvingKey, circuits: Sequence, instances,
                 rng=None, transcript: Optional[Blake2bWrite] = None,
                 multiopen: str = "gwc", h_device: Optional[bool] = None,
                 mesh=None, h_mxu: Optional[bool] = None) -> bytes:
    """instances: per-circuit list of per-column instance value lists.

    h_device: evaluate h on the device (True) or with the host reference
    evaluator (False); None = default_h_device().  Proof bytes are the same
    either way.

    mesh: optional jax.sharding.Mesh — shards the fused device h-path over
    the mesh's "x" axis (multi-device proving; implies h_device).

    h_mxu: force the int8 matmul-NTT basis conversions in the device h-path
    on/off (None = the rule in device_eval.build_h_fn)."""
    if mesh is not None:
        h_device = True
    elif h_device is None:
        h_device = default_h_device()
    rng = rng or _SystemRng()
    transcript = transcript or Blake2bWrite()
    cs = pk.vk.cs
    domain = pk.vk.domain
    n = params.n

    assert len(circuits) == len(instances)
    for inst in instances:
        if len(inst) != cs.num_instance_columns:
            raise ValueError("InvalidInstances")

    mark = profiler.marker("create_proof")

    # Prefetch the device h pipeline on a background thread FIRST — before
    # even vk.hash_into — to maximize the overlap window: building the
    # per-pk consts/plans and compiling or loading the fused executable
    # depends only on the proving key (shapes), so it overlaps everything
    # from the vk hash through the GIL-releasing native witness/commitment/
    # CQ phases.
    # A production service calls prewarm_prover(pk) at boot instead, making
    # the first request's prove ~warm.  The h phase joins before use;
    # get_h_fn memoizes on pk.
    h_prefetch = None
    if h_device and mesh is None:
        h_prefetch = prewarm_prover(pk, h_mxu=h_mxu)

    pk.vk.hash_into(transcript)

    # instance values -> lagrange + coeff polys; raw values absorbed into the
    # transcript up front (prover.rs:100-131 / verifier.rs:52-55 order)
    instance_singles = []
    for inst in instances:
        values = []
        polys = []
        for col in inst:
            if len(col) > n - (cs.blinding_factors() + 1):
                raise ValueError("InstanceTooLarge")
            v = list(col) + [0] * (n - len(col))
            values.append(v)
            polys.append(domain.lagrange_to_coeff_host(v))
        instance_singles.append({"values": values, "polys": polys})
        for col in inst:
            for v in col:
                transcript.common_scalar(v % P)

    # ---- witness generation --------------------------------------------
    # Phase-major over circuits (prover.rs:299-391): within each phase every
    # circuit synthesizes and commits its advice, THEN the phase challenges
    # are squeezed — so multi-circuit proofs share challenges correctly.
    unusable_rows_start = n - (cs.blinding_factors() + 1)
    phases = cs.phases()
    challenges: dict = {}
    configs = [type(c).configure(ConstraintSystem()) for c in circuits]
    witnesses = [
        _WitnessCollection(cs, n, unusable_rows_start, inst_single["values"],
                           phases[0], challenges)
        for inst_single in instance_singles
    ]
    advice_singles = [
        {"values": [[0] * n for _ in range(cs.num_advice_columns)],
         "bufs": [None] * cs.num_advice_columns,
         "commitments": [None] * cs.num_advice_columns}
        for _ in circuits
    ]
    from ..native_loader import fr_buf, get_lib
    use_bufs = get_lib() is not None and n >= 1024
    for phase in phases:
        for c_idx, circuit in enumerate(circuits):
            witness = witnesses[c_idx]
            witness.current_phase = phase
            planner_for(circuit).synthesize(
                witness, circuit, configs[c_idx], cs.constants)
            # blind every phase column (rng order preserved), then commit
            # them all in ONE native multi-MSM call before transcribing in
            # column order (prover.rs:299-391 batches the same way).  Each
            # column is limb-packed ONCE; the buffer is reused by the CQ
            # f-fold and the device h-path input pack.
            phase_cols = []
            for col_idx, col_phase in enumerate(cs.advice_column_phase):
                if col_phase != phase:
                    continue
                col = list(witness.advice[col_idx])
                for row in range(unusable_rows_start, n):
                    col[row] = rng.randrange(P)
                advice_singles[c_idx]["values"][col_idx] = col
                if use_bufs:
                    buf = fr_buf([v % P for v in col])
                    advice_singles[c_idx]["bufs"][col_idx] = buf
                    phase_cols.append((col_idx, buf))
                else:
                    phase_cols.append((col_idx, col))
            cms = params.commit_lagrange_many([c for _, c in phase_cols])
            for (col_idx, _), cm in zip(phase_cols, cms):
                advice_singles[c_idx]["commitments"][col_idx] = cm
                transcript.write_point(cm)
        for ch_idx, ch_phase in enumerate(cs.challenge_phase):
            if ch_phase == phase:
                challenges[ch_idx] = transcript.squeeze_challenge()

    mark("witness_and_advice_commit")
    challenges_list = [challenges[i] for i in range(cs.num_challenges)]

    # Stage the advice/instance device stacks NOW, on a thread: the native
    # pack + transfer (~26 MB at k=13, ~210 MB at k=16) releases the GIL and
    # rides under the native CQ/permutation phases below.  (z/lookup/CQ-b
    # columns can't stage early — they are produced by those phases.)
    staged_h = None
    stage_thread = None
    if h_device and mesh is None:
        import threading as _threading

        from .device_eval import stack_columns
        staged_h = [dict() for _ in circuits]

        def _stage():
            try:
                for c_idx in range(len(circuits)):
                    adv_c = [b if b is not None else v
                             for b, v in zip(advice_singles[c_idx]["bufs"],
                                             advice_singles[c_idx]["values"])]
                    staged_h[c_idx]["advice"] = stack_columns(adv_c, n)
                    staged_h[c_idx]["instance"] = stack_columns(
                        instance_singles[c_idx]["values"], n)
                    profiler.count("rt_stage_upload", 2)
            except Exception as e:  # staging is an optimization only
                print(f"[h stage] failed (h pack will rebuild): {e!r:.120}",
                      flush=True)

        stage_thread = _threading.Thread(target=_stage, daemon=True)
        stage_thread.start()
        mark("h_stage_advice")

    # ---- theta; lookups + CQ commit ------------------------------------
    theta = transcript.squeeze_challenge()

    lookups_permuted = []
    for inst_single, adv in zip(instance_singles, advice_singles):
        lookups_permuted.append([
            lookup_commit_permuted(
                arg, pk, params, theta, adv["values"], pk.fixed_values,
                inst_single["values"], challenges_list, rng, transcript)
            for arg in cs.lookups
        ])

    mark("lookup_permute")
    static_committed = []
    for inst_single, adv in zip(instance_singles, advice_singles):
        # rotation-0 column-query inputs reuse the transcribed column
        # commitments for [f]_1 (commit_lagrange is linear in the values)
        col_cms = {("advice", i): cm
                   for i, cm in enumerate(adv["commitments"]) if cm is not None}
        col_cms.update({("fixed", i): cm
                        for i, cm in enumerate(pk.vk.fixed_commitments)})
        col_bufs = {("advice", i): b
                    for i, b in enumerate(adv["bufs"]) if b is not None}
        static_committed.append(static_lookup_commit_all(
            cs.static_lookups, pk, params, theta, challenges_list,
            adv["values"], pk.fixed_values, inst_single["values"],
            transcript, rng=rng, column_commitments=col_cms,
            column_buffers=col_bufs))

    mark("cq_commit_f_m")
    stage_f_thread = None
    if staged_h is not None:
        # the CQ f coeff polys exist BEFORE beta (commit_all converts them);
        # start their ~half-of-the-static-stack transfer now — on a thread
        # (4.4 s of packing at k=17) — so it rides under the permutation/
        # log-derivative phases below (the b half is produced by those
        # phases and cannot stage early)
        from .device_eval import stack_columns as _sc

        def _stage_f():
            try:
                for c_idx, per_circuit in enumerate(static_committed):
                    if per_circuit and all("f_coeff" in r
                                           for r in per_circuit):
                        staged_h[c_idx]["static_f"] = _sc(
                            [r["f_coeff"] for r in per_circuit], n)
                        profiler.count("rt_stage_upload", 1)
            except Exception as e:  # staging is an optimization only
                print(f"[h stage f] failed (h pack will rebuild): "
                      f"{e!r:.120}", flush=True)

        import threading as _threading2
        stage_f_thread = _threading2.Thread(target=_stage_f, daemon=True)
        stage_f_thread.start()
        mark("h_stage_f")

    # ---- beta, gamma; permutations; products; CQ log derivatives --------
    beta = transcript.squeeze_challenge()
    gamma = transcript.squeeze_challenge()

    permutations = []
    for inst_single, adv in zip(instance_singles, advice_singles):
        permutations.append(permutation_commit(
            pk, params, adv["values"], pk.fixed_values, inst_single["values"],
            beta, gamma, rng, transcript))

    mark("permutation_grand_products")
    lookups_committed = [
        [lookup_commit_product(pm, pk, params, beta, gamma, rng, transcript)
         for pm in per_circuit]
        for per_circuit in lookups_permuted
    ]

    mark("lookup_grand_products")
    static_log = [
        static_lookup_log_derivatives_all(
            per_circuit, pk, params, domain, beta, theta, transcript)
        for per_circuit in static_committed
    ]

    mark("cq_log_derivatives")
    # ---- vanishing + y + h ----------------------------------------------
    vanishing = vanishing_commit(params, domain, rng, transcript)
    y = transcript.squeeze_challenge()

    if h_device:
        # Device path: ONE jitted dispatch covers every basis conversion, the
        # h accumulation, the vanishing quotient and the return to coeffs.
        # Multi-circuit proofs dispatch the SAME executable once per circuit
        # and combine the per-circuit quotients on host: every VM term folds
        # the accumulator by y exactly once, and the quotient pipeline
        # (divide by Z_H, iNTT, ZETA scale) is linear, so
        # h = sum_c h_c * y^{T*(nc-1-c)} with T the program's fold count —
        # the sharded analogue of evaluation.rs:285-374's circuit-major loop.
        import jax.numpy as _jnp
        from ..fields import device as Dv
        from .device_eval import get_h_fn, prepare_h_inputs
        from .vanishing import vanishing_construct_from_coeffs

        use_mxu = h_mxu if mesh is None else False

        with profiler.phase("h_fn_build"):
            if stage_thread is not None:
                stage_thread.join()
            if stage_f_thread is not None:
                stage_f_thread.join()
            if h_prefetch is not None:
                h_prefetch.join()
            h_fn = get_h_fn(pk, use_mxu=use_mxu)
        adv_cols = [
            [b if b is not None else v
             for b, v in zip(adv["bufs"], adv["values"])]
            for adv in advice_singles
        ]
        ncols = cs.num_advice_columns
        h_bufs = []
        advice_coeff = []
        for c_idx in range(len(circuits)):
            with profiler.phase("h_pack_inputs"):
                inputs = prepare_h_inputs(
                    pk, [adv_cols[c_idx]],
                    [instance_singles[c_idx]["values"]],
                    challenges_list, y, beta, gamma, theta,
                    [lookups_committed[c_idx]], [static_log[c_idx]],
                    [permutations[c_idx]], mesh=mesh,
                    staged=staged_h[c_idx] if staged_h else None)
            # x-eval coeff polys: the in-graph l2c intermediate is also
            # on device, but when the advice columns are already resident
            # as host limb buffers, one native multi-iNTT reproduces the
            # identical coeffs without a device->host fetch.  Polys stay
            # (n, 4) buffers (arith.as_coeff_list form): the x-evals and
            # multiopen folds consume them natively.  The iNTT runs on a
            # THREAD so it rides under the h dispatch wait.
            bufs = advice_singles[c_idx]["bufs"]
            intt_box: dict = {}
            intt_thread = None
            if all(b is not None for b in bufs) and ncols:
                import threading as _th3

                from ..native_loader import native_fr_ntt_multi
                from ..ops.ntt import _host_twiddle_buf

                def _advice_intt(bufs=bufs, box=intt_box):
                    try:
                        polys = [b.copy() for b in bufs]
                        omega_inv = pow(domain.omega, P - 2, P)
                        native_fr_ntt_multi(
                            polys, _host_twiddle_buf(omega_inv, n, P),
                            domain.k, ninv=pow(n, P - 2, P))
                        box["polys"] = polys
                    except Exception as e:  # fall through to device coeffs
                        print(f"[advice intt] failed: {e!r:.120}", flush=True)

                intt_thread = _th3.Thread(target=_advice_intt, daemon=True)
                intt_thread.start()
            h_dev, advice_coeff_dev = h_fn(inputs)
            with profiler.phase("h_unpack"):
                profiler.count("rt_h_fetch", 1)
                h_bufs.append(Dv.unpack_buf(h_dev, Dv.FR))
            with profiler.phase("h_advice_ntt"):
                if intt_thread is not None:
                    intt_thread.join()
                if "polys" in intt_box:
                    advice_coeff.append({"polys": intt_box["polys"]})
                else:
                    flat = Dv.unpack_buf(advice_coeff_dev, Dv.FR)
                    advice_coeff.append(
                        {"polys": [flat[i * n:(i + 1) * n]
                                   for i in range(ncols)]})
        with profiler.phase("h_commit"):
            from ..native_loader import fr_unbuf, native_fr_fold_buf
            h_acc = h_bufs[0]
            if len(h_bufs) > 1:
                from ..native_loader import fr_buf
                from .h_vm import program_y_fold_count
                y_t = pow(y, program_y_fold_count(pk), P)
                for nxt in h_bufs[1:]:
                    if not native_fr_fold_buf(h_acc, nxt, y_t):
                        h_acc = fr_buf([
                            (a * y_t + b) % P
                            for a, b in zip(fr_unbuf(h_acc), fr_unbuf(nxt))])
            vanishing = vanishing_construct_from_coeffs(
                vanishing, params, domain, fr_unbuf(h_acc), transcript)
    else:
        advice_coeff = [
            {"polys": [domain.lagrange_to_coeff_host(v) for v in adv["values"]]}
            for adv in advice_singles
        ]
        advice_cosets = [
            [domain.coeff_to_extended_host(p) for p in adv["polys"]]
            for adv in advice_coeff
        ]
        instance_cosets = [
            [domain.coeff_to_extended_host(p) for p in inst["polys"]]
            for inst in instance_singles
        ]

        h_values = evaluate_h(
            pk, advice_cosets, instance_cosets, challenges_list, y, beta, gamma,
            theta, lookups_committed, static_log, permutations)

        vanishing = vanishing_construct(vanishing, params, domain, h_values, rng, transcript)

    mark("h_eval_and_commit")
    # ---- x; evals --------------------------------------------------------
    x = transcript.squeeze_challenge()
    xn = pow(x, n, P)

    fixed_polys = _fixed_poly_bufs(pk, n)
    for adv in advice_coeff:
        for column, rot in cs.advice_queries:
            transcript.write_scalar(
                A.eval_polynomial(adv["polys"][column.index], domain.rotate_omega(x, rot)))
    for column, rot in cs.fixed_queries:
        transcript.write_scalar(
            A.eval_polynomial(fixed_polys[column.index], domain.rotate_omega(x, rot)))

    vanishing = vanishing_evaluate(vanishing, x, xn, domain, transcript)
    permutation_pk_evaluate(pk, x, transcript)
    for perm in permutations:
        permutation_evaluate(perm, pk, x, transcript)
    for per_circuit in lookups_committed:
        for lk in per_circuit:
            lookup_evaluate(lk, pk, x, transcript)
    for per_circuit in static_log:
        for sl in per_circuit:
            static_lookup_evaluate(sl, x, transcript)

    mark("point_evals")
    # ---- multiopen -------------------------------------------------------
    queries: List[ProverQuery] = []
    for adv, inst_single, perm, lks, sls in zip(
            advice_coeff, instance_singles, permutations, lookups_committed, static_log):
        for column, rot in cs.advice_queries:
            queries.append(ProverQuery(
                domain.rotate_omega(x, rot), adv["polys"][column.index]))
        queries.extend(permutation_open(perm, pk, x))
        for lk in lks:
            queries.extend(lookup_open(lk, pk, x))
        for sl in sls:
            queries.extend(static_lookup_open(sl, x))
    for column, rot in cs.fixed_queries:
        queries.append(ProverQuery(
            domain.rotate_omega(x, rot), fixed_polys[column.index]))
    queries.extend(permutation_pk_open(pk, x))
    queries.extend(vanishing_open(vanishing, x))

    if multiopen == "gwc":
        gwc_create_proof(params, queries, transcript)
    elif multiopen == "shplonk":
        from ..poly.kzg.shplonk import shplonk_create_proof
        shplonk_create_proof(params, queries, transcript)
    else:
        raise ValueError(f"unknown multiopen scheme {multiopen!r}")
    mark("multiopen")
    return transcript.finalize()
