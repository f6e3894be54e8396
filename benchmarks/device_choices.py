"""Measure the device-path choices the code makes:

  form    mont_mul formulation (fields/device.mont_mul uses the compact scan
          form; the unrolled register form is patched in for comparison),
          as the compile and run time of the k=13 SHA-256 h program;
  routes  basis conversions (device_eval.build_h_fn use_mxu): int8 matmul
          NTT vs uint32 butterflies in the same program; after one compile
          of each, the warm proves of the two routes alternate;
  plan    matmul NTT plan width (ops/mxu_ntt.auto_max_m): 512 vs 1024 at
          the prover's sizes;
  trace   where a matmul NTT spends its device time (GEMM vs the
          elementwise digit-plane epilogue), from a profiler trace.

Everything runs in one process with the AOT executable cache off; with the
form section the persistent compile cache is off too, so every compile is
timed cold.  All variants must produce identical proof bytes.

Usage: python benchmarks/device_choices.py [--only form,routes,plan,trace]
           [--k 13] [--blocks 64] [--proves 7] [--unrolled-budget 600]
Writes the trace under .cache/traces/device_choices/.
"""
import argparse
import os
import random
import statistics
import sys
import time

os.environ["SHA2CQ_AOT_CACHE"] = "0"
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402

import chip_smoke as S  # noqa: E402
from sha2cq_tpu.fields import device as D  # noqa: E402
from sha2cq_tpu.fields.host import FR_MOD, FR_ROOT_OF_UNITY, FR_S  # noqa: E402
from sha2cq_tpu.ops import mxu_ntt as MX  # noqa: E402
from sha2cq_tpu.plonk import create_proof  # noqa: E402
from sha2cq_tpu.utils.profiling import profiler  # noqa: E402

H_PHASES = ("h_oneprog", "h_convert", "h_chunks", "h_quotient")
SECTIONS = ("form", "routes", "plan", "trace")


def log(*a):
    print(*a, flush=True)


def h_seconds() -> float:
    t = profiler.timings()
    return sum(t.get(p, 0.0) for p in H_PHASES)


def reset_h(pk):
    for key in ("_h_fn", "_h_fn_mxu", "_h_fn_auto", "_h_prefetch"):
        pk.__dict__.pop(key, None)
    jax.clear_caches()


def sha_pk(k: int, blocks: int):
    rng = random.Random(0x5256)
    msg = [[rng.randrange(256) for _ in range(16)] for _ in range(blocks)]
    circuit, params, vk, pk = S.sha_setup(8, k, rng.randrange(1 << 250), msg)
    return circuit, params, pk, circuit.expected_digest()


def prove_once(setup, use_mxu: bool):
    """(proof, h seconds, prove seconds) of one device-h prove."""
    circuit, params, pk, digest = setup
    profiler.enable()
    profiler.reset()
    t0 = time.perf_counter()
    proof = create_proof(params, pk, [circuit], [[digest]],
                         rng=random.Random(7), h_device=True, h_mxu=use_mxu)
    dt = time.perf_counter() - t0
    h = h_seconds()
    profiler.disable()
    return proof, h, dt


def mont_mul_form(setup, k: int, card: str, unrolled_budget_s: float) -> None:
    """Compact against unrolled mont_mul in the matmul-route h program, each
    compiled cold.  The unrolled variant runs under a budget; past it the
    process prints so and exits."""
    import threading
    compact = D.mont_mul
    ref = None
    for form in ("compact", "unrolled"):
        D.mont_mul = (compact if form == "compact" else
                      lambda a, b, ctx=D.FR: D._mont_mul_unrolled(a, b, ctx))
        reset_h(setup[2])
        done = threading.Event()
        if form == "unrolled":
            t_start = time.perf_counter()

            def watchdog():
                if not done.wait(unrolled_budget_s):
                    log(f"h k={k} unrolled mont_mul: first prove unfinished "
                        f"after {time.perf_counter() - t_start:.0f}s "
                        f"(compile included) [{card}]")
                    os._exit(0)
            threading.Thread(target=watchdog, daemon=True).start()
        runs = [prove_once(setup, True) for _ in range(3)]
        done.set()
        ref = ref or runs[0][0]
        assert all(r[0] == ref for r in runs), f"{form}: proof bytes differ"
        log(f"h k={k} {form} mont_mul, matmul NTT: first h {runs[0][1]:.2f}s "
            f"(compile+run), warm h {min(r[1] for r in runs[1:]) * 1e3:.1f} "
            f"ms; prove cold {runs[0][2]:.2f}s warm "
            f"{min(r[2] for r in runs[1:]):.2f}s [{card}]")
    D.mont_mul = compact
    reset_h(setup[2])


def spread(xs) -> str:
    return (f"min {min(xs):.3f} median {statistics.median(xs):.3f} "
            f"max {max(xs):.3f}")


def ntt_routes(setup, k: int, card: str, proves: int) -> None:
    """Matmul against butterfly basis conversions in the h program: one
    cold prove of each (compile included), then `proves` warm proves of
    each, alternating so that host drift falls on both alike."""
    ref = None
    for use_mxu in (True, False):     # get_h_fn keeps one h_fn per route
        proof, h, dt = prove_once(setup, use_mxu)
        ref = ref or proof
        assert proof == ref, "route proofs differ"
        log(f"h k={k} {'matmul' if use_mxu else 'butterfly'} NTT: first h "
            f"{h:.2f}s (compile+run), cold prove {dt:.2f}s [{card}]")
    warm = {True: [], False: []}
    for _ in range(proves):
        for use_mxu in (True, False):
            proof, h, dt = prove_once(setup, use_mxu)
            assert proof == ref, "route proofs differ"
            warm[use_mxu].append((h, dt))
    for use_mxu in (True, False):
        hs = [w[0] * 1e3 for w in warm[use_mxu]]
        ps = [w[1] for w in warm[use_mxu]]
        log(f"h k={k} {'matmul' if use_mxu else 'butterfly'} NTT, {proves} "
            f"warm proves: h ms {spread(hs)}; prove s {spread(ps)} [{card}]")


def plan_width(card: str, sizes=(14, 18, 20)) -> None:
    for k in sizes:
        n = 1 << k
        omega = pow(FR_ROOT_OF_UNITY, 1 << (FR_S - k), FR_MOD)
        x = jax.numpy.asarray(D.np_pack_buf(S._random_fr_buf(n, k), D.FR))
        outs = []
        for m in (512, 1024):
            first, warm, out = S.timed(
                lambda a, m=m: MX.mxu_ntt(a, omega, k, max_m=m), x, reps=10)
            outs.append(np.asarray(out))
            log(f"matmul ntt 2^{k} max_m={m}: first {first:.2f}s, warm "
                f"{warm * 1e3:.3f} ms [{card}]")
        assert np.array_equal(*outs), f"2^{k}: plan widths disagree"
        MX.get_plan.cache_clear()
        MX._dft_digit_matrix.cache_clear()


def trace_ntt(card: str, out_dir: str, k: int = 18, ke: int = 14,
              ncols: int = 64) -> None:
    """Per-kernel device time of warm matmul NTTs: a 2^k transform and one
    c2e conversion chunk of the k=13 prover (ncols columns at 2^ke)."""
    n = 1 << k
    omega = pow(FR_ROOT_OF_UNITY, 1 << (FR_S - k), FR_MOD)
    x = jax.numpy.asarray(D.np_pack_buf(S._random_fr_buf(n, 1), D.FR))
    we = pow(FR_ROOT_OF_UNITY, 1 << (FR_S - ke), FR_MOD)
    plan, res = MX.get_plan(1 << ke, we, "Fr")
    cols = jax.numpy.asarray(
        D.np_pack_buf(S._random_fr_buf(ncols << ke, 2), D.FR)).reshape(
            D.NLIMB, ncols, 1 << ke)
    batch = jax.jit(lambda a, p: MX.mxu_ntt_batch_mapped(a, p, res))
    jax.block_until_ready(MX.mxu_ntt(x, omega, k))
    jax.block_until_ready(batch(cols, plan))
    reps = 5
    with jax.profiler.trace(out_dir):
        for _ in range(reps):
            with jax.profiler.TraceAnnotation(f"ntt_2e{k}"):
                jax.block_until_ready(MX.mxu_ntt(x, omega, k))
        for _ in range(reps):
            with jax.profiler.TraceAnnotation(f"c2e_{ncols}x2e{ke}"):
                jax.block_until_ready(batch(cols, plan))
    summarize_trace(out_dir, reps, card)


def summarize_trace(out_dir: str, reps: int, card: str) -> None:
    import glob
    from collections import defaultdict
    paths = glob.glob(os.path.join(out_dir, "**", "*.xplane.pb"),
                      recursive=True)
    prof = jax.profiler.ProfileData.from_file(max(paths, key=os.path.getmtime))
    per_kernel = defaultdict(lambda: [0, 0])
    for plane in prof.planes:
        if "GPU" not in plane.name:
            continue
        for line in plane.lines:
            if "Stream" not in line.name and "stream" not in line.name:
                continue
            for ev in line.events:
                rec = per_kernel[ev.name]
                rec[0] += ev.duration_ns
                rec[1] += 1
    total = sum(v[0] for v in per_kernel.values())
    gemm = sum(v[0] for name, v in per_kernel.items()
               if any(s in name.lower() for s in
                      ("gemm", "cublas", "dot", "imma", "cutlass", "matmul")))
    log(f"trace: {len(per_kernel)} distinct kernels, {sum(v[1] for v in per_kernel.values())} "
        f"launches, device time {total / 1e6 / reps:.3f} ms per rep (both "
        f"workloads), GEMM share {gemm / max(total, 1):.3f} [{card}]")
    for name, (ns, cnt) in sorted(per_kernel.items(),
                                  key=lambda kv: -kv[1][0])[:25]:
        log(f"  {ns / 1e6 / reps:9.3f} ms/rep  x{cnt // reps:<4d} {name[:110]}")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", default=",".join(SECTIONS),
                    help="comma-separated sections: " + ",".join(SECTIONS))
    ap.add_argument("--k", type=int, default=13)
    ap.add_argument("--blocks", type=int, default=64)
    ap.add_argument("--proves", type=int, default=7,
                    help="warm proves per NTT route")
    ap.add_argument("--unrolled-budget", type=float, default=600.0)
    args = ap.parse_args()
    sections = args.only.split(",")
    assert set(sections) <= set(SECTIONS), sections
    if "form" in sections:
        jax.config.update("jax_enable_compilation_cache", False)
    card = S.gpu_name_and_power() if jax.default_backend() == "gpu" \
        else "CPU rehearsal, not a device measurement"
    log(f"card: {card}; backend {jax.default_backend()}")
    out_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), ".cache", "traces", "device_choices")
    setup = (sha_pk(args.k, args.blocks)
             if {"form", "routes"} & set(sections) else None)
    steps = {
        "trace": lambda: trace_ntt(card, out_dir),
        "plan": lambda: plan_width(card),
        "routes": lambda: ntt_routes(setup, args.k, card, args.proves),
        "form": lambda: mont_mul_form(setup, args.k, card,
                                      args.unrolled_budget),
    }
    for name in sections:
        t0 = time.perf_counter()
        try:
            steps[name]()
        except Exception as e:
            log(f"{name}: FAILED {e!r}")
        log(f"{name}: {time.perf_counter() - t0:.1f}s")


if __name__ == "__main__":
    main()
