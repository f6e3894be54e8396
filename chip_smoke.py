#!/usr/bin/env python3
"""Smoke test of the prover on an NVIDIA GPU: the quickest proof that the
system still starts and proves correctly on the card.

    python chip_smoke.py                # one GPU: device, kernels, prove
    python chip_smoke.py --fips32       # real FIPS SHA-256, 32-bit tables
    python chip_smoke.py --four-cards   # mesh-sharded proof over 4 GPUs

Default phases, all in this one process (a JAX process reserves most of the
card's memory, so no second process may open it):

  device   JAX must report platform "gpu"; prints the card's name and power
           limit from nvidia-smi.  No CPU fallback.
  kernels  Exact integer kernels at real widths, compared bit for bit
           (tolerance 0) with plain references: both mont_mul forms over
           2^20 Fr elements; forward and inverse NTT at 2^13, 2^14 (the k=13
           extended domain) and 2^18 through the butterfly (ops/ntt.py) and
           int8-matmul (ops/mxu_ntt.py) routes against the native C NTT;
           msm_device at 2^12 against the native Pippenger.
  prove    The SHA-256 circuit (models/sha/circuit32.py) with 8-bit words,
           k=13, 64 chained blocks: keygen_vk/keygen_pk -> create_proof (h on
           the device, the default off the CPU) -> verify_proof.  The digest
           is checked against models/sha/sha256.py and the proof bytes
           against the host-h reference path under the same rng.

The last line of standard output is one JSON object,
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}},
printed only when every phase passed.  Any failure exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import os
import random
import subprocess
import sys
import threading
import time
import traceback

# Word-width cut of the default prove phase: the FIPS circuit code at 8-bit
# words has the same columns, lookups and rows per block as at 32 bits; only
# the CQ tables shrink (2^12 rows instead of 2^18), so their one-time setup
# takes seconds instead of hours.
PROVE_K = 13
PROVE_BLOCKS = 64
PROVE_WORD_BITS = 8
MONT_MUL_LOG_N = 20
NTT_LOG_SIZES = (13, 14, 18)
MSM_LOG_N = 12
MESH_LOG_N = 16
# toxic waste pinned so the 32-bit table setup keys one cache entry
FIPS32_SECRET = 0x2b068e00660fd714ab61695867925740388c0d300215adf8c964f5d93e9a76e7


def log(*args) -> None:
    print(*args, flush=True)


def gpu_name_and_power() -> str:
    """`nvidia-smi --query-gpu=name,power.limit` lines; raises if unreadable."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    if not out:
        raise RuntimeError("nvidia-smi printed nothing")
    return out


def card_tag(smi: str) -> str:
    """One-line card label for measurements: nvidia-smi prints a line per
    card, and identical cards are counted instead of repeated."""
    lines = smi.splitlines()
    if len(set(lines)) == 1 and len(lines) > 1:
        return f"{len(lines)} x {lines[0]}"
    return "; ".join(lines)


def check_device(devices, want_count: int = 1) -> dict:
    """The device record of the last line; refuses anything but a GPU."""
    if not devices:
        raise RuntimeError("JAX reports no devices")
    d = devices[0]
    if d.platform != "gpu":
        raise RuntimeError(
            f"JAX platform is {d.platform!r}, not 'gpu': this smoke test "
            "measures the card and has no CPU fallback")
    if len(devices) < want_count:
        raise RuntimeError(f"{len(devices)} device(s), need {want_count}")
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devices)}


class Phases:
    """Runs named phases, keeps going after a failure, remembers it."""

    def __init__(self):
        self.failed = []

    def run(self, name, fn, *args, **kwargs):
        log(f"== phase {name}")
        t0 = time.perf_counter()
        try:
            out = fn(*args, **kwargs)
        except Exception:
            traceback.print_exc()
            sys.stdout.flush()
            log(f"== phase {name}: FAILED after "
                f"{time.perf_counter() - t0:.1f}s")
            self.failed.append(name)
            return None
        log(f"== phase {name}: ok in {time.perf_counter() - t0:.1f}s")
        return out


def timed(fn, *args, reps: int = 5):
    """(first-call seconds incl. compile, median warm seconds, result)."""
    import jax
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    warm = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        warm.append(time.perf_counter() - t0)
    return first, sorted(warm)[len(warm) // 2], out


# ------------------------------- device --------------------------------------

def phase_device(card: str, want_count: int = 1) -> dict:
    import jax

    from sha2cq_tpu import compile_cache_dir
    dev = check_device(jax.devices(), want_count)
    log(f"device_kind {dev['kind']}; device count {dev['count']}; "
        f"jax {jax.__version__}")
    log(f"XLA_FLAGS={os.environ.get('XLA_FLAGS', '')!r}")
    log(f"compile cache {compile_cache_dir()} "
        f"(JAX_COMPILATION_CACHE_DIR "
        f"{'set' if os.environ.get('JAX_COMPILATION_CACHE_DIR') else 'unset'})")
    log(f"nproc {os.cpu_count()}")
    log(f"card: {card}")
    return dev


# ------------------------------- kernels -------------------------------------

def _random_fr_buf(n: int, seed: int):
    """(n, 4) u64 canonical Fr limb buffer (values < p)."""
    import numpy as np

    from sha2cq_tpu.fields.host import FR_MOD
    rng = np.random.default_rng(seed)
    buf = rng.integers(0, 1 << 63, size=(n, 4), dtype=np.uint64) * 2 \
        + rng.integers(0, 2, size=(n, 4), dtype=np.uint64)
    buf[:, 3] %= np.uint64(FR_MOD >> 192)
    return np.ascontiguousarray(buf)


def check_mont_mul(log_n: int, card: str) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np

    from sha2cq_tpu import native_loader as NL
    from sha2cq_tpu.fields import device as D
    from sha2cq_tpu.fields.host import FR_MOD
    n = 1 << log_n
    xa, xb = _random_fr_buf(n, 1), _random_fr_buf(n, 2)
    a = jnp.asarray(D.np_pack_buf(xa, D.FR))
    b = jnp.asarray(D.np_pack_buf(xb, D.FR))
    outs = {}
    for name, fn in (("unrolled", D._mont_mul_unrolled),
                     ("compact", D._mont_mul_compact)):
        f = jax.jit(lambda a, b, fn=fn: fn(a, b, D.FR))
        first, warm, outs[name] = timed(f, a, b)
        log(f"mont_mul {name} 2^{log_n}: first call {first:.2f}s, "
            f"warm {warm * 1e3:.3f} ms = {n / warm / 1e6:.1f} M mul/s "
            f"[{card}]")
    assert bool(jnp.all(outs["unrolled"] == outs["compact"])), \
        "compact and unrolled mont_mul differ"
    # Montgomery inputs aR, bR -> abR: the plain value is a*b mod p
    idx = np.arange(0, n, n // 4096)
    got = NL.fr_unbuf(D.unpack_buf(outs["unrolled"][:, idx], D.FR))
    xs, ys = NL.fr_unbuf(xa[idx]), NL.fr_unbuf(xb[idx])
    assert got == [x * y % FR_MOD for x, y in zip(xs, ys)], \
        "mont_mul != host bigints"
    log(f"mont_mul 2^{log_n}: both forms bit-identical; 4096 samples equal "
        "host bigints")


def check_ntts(log_sizes, card: str) -> None:
    import numpy as np

    from sha2cq_tpu.fields import device as D
    from sha2cq_tpu.fields.host import FR_MOD, FR_ROOT_OF_UNITY, FR_S
    from sha2cq_tpu.native_loader import native_fr_ntt_multi
    from sha2cq_tpu.ops import mxu_ntt as MX
    from sha2cq_tpu.ops import ntt as NTT
    import jax
    import jax.numpy as jnp
    P = FR_MOD
    for k in log_sizes:
        n = 1 << k
        omega = pow(FR_ROOT_OF_UNITY, 1 << (FR_S - k), P)
        omega_inv = pow(omega, P - 2, P)
        ninv = pow(n, P - 2, P)
        buf = _random_fr_buf(n, 100 + k)
        fwd = buf.copy()
        assert native_fr_ntt_multi([fwd], NTT._host_twiddle_buf(omega, n, P), k)
        inv = buf.copy()
        assert native_fr_ntt_multi(
            [inv], NTT._host_twiddle_buf(omega_inv, n, P), k, ninv=ninv)
        x = jnp.asarray(D.np_pack_buf(buf, D.FR))
        # the butterfly routes jit whole (intt's 1/n scale is outside
        # ntt_last_axis); the matmul routes are jitted inside and build their
        # device-resident plans eagerly on first use
        routes = {
            "butterfly": (jax.jit(lambda a: NTT.ntt(a, omega, k)),
                          jax.jit(lambda a: NTT.intt(a, omega_inv, k, ninv))),
            "matmul": (lambda a: MX.mxu_ntt(a, omega, k),
                       lambda a: MX.mxu_intt(a, omega_inv, k, ninv)),
        }
        for route, (f, fi) in routes.items():
            for direction, fn, ref in (("fwd", f, fwd), ("inv", fi, inv)):
                first, warm, out = timed(fn, x)
                ok = np.array_equal(D.unpack_buf(out, D.FR), ref)
                log(f"ntt {route} {direction} 2^{k}: first call {first:.2f}s, "
                    f"warm {warm * 1e3:.3f} ms, bit-exact {ok} [{card}]")
                assert ok, f"{route} {direction} NTT 2^{k} != native fr_ntt"


def check_msm(log_n: int, card: str) -> None:
    import random as _r

    from sha2cq_tpu.fields.host import FR_MOD
    from sha2cq_tpu.ops import msm as M
    from sha2cq_tpu.poly.kzg.params import ParamsKZG
    n = 1 << log_n
    rng = _r.Random(12)
    points = ParamsKZG.setup_from_toxic_waste(log_n, rng.randrange(FR_MOD)).g
    scalars = [rng.randrange(FR_MOD) for _ in range(n)]
    t0 = time.perf_counter()
    dev = M.msm_device(scalars, points)
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    dev2 = M.msm_device(scalars, points)
    warm = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = M.msm_host(scalars, points)
    host_s = time.perf_counter() - t0
    log(f"msm_device 2^{log_n}: first call {first:.2f}s, warm {warm:.3f}s "
        f"[{card}]; native host Pippenger {host_s:.3f}s")
    assert dev == dev2 == host, "msm_device != native Pippenger"
    log(f"msm_device 2^{log_n}: equal to the native Pippenger")


# -------------------------------- prove --------------------------------------

def sha_setup(word_bits: int, k: int, secret: int, blocks):
    """(circuit class, circuit, params, vk, pk, digest) for circuit32."""
    from sha2cq_tpu.models.sha.circuit32 import Sha256Circuit
    from sha2cq_tpu.models.sha.setup32 import build_sha256_setup
    from sha2cq_tpu.models.sha.tables32 import HalfScheme
    from sha2cq_tpu.plonk import keygen_pk, keygen_vk
    from sha2cq_tpu.poly.kzg.params import ParamsKZG

    class Circuit(Sha256Circuit):
        SCHEME = HalfScheme(word_bits)

    t0 = time.perf_counter()
    tables, configs, b0, _ = build_sha256_setup(
        Circuit.SCHEME, 1 << k, secret, progress=word_bits > 8)
    params = ParamsKZG.setup_from_toxic_waste(k, secret)
    log(f"table setup ({word_bits}-bit words, k={k}): "
        f"{time.perf_counter() - t0:.1f}s")
    circuit = Circuit(blocks, tables)
    t0 = time.perf_counter()
    vk = keygen_vk(params, circuit)
    pk = keygen_pk(params, configs, b0, vk, circuit)
    log(f"keygen: {time.perf_counter() - t0:.1f}s; domain k={vk.domain.k}, "
        f"extended k={vk.domain.extended_k}")
    return circuit, params, vk, pk


def model_digest(blocks, word_bits: int):
    from sha2cq_tpu.models.sha import sha256 as model
    state = model.h_constants(word_bits)
    for block in blocks:
        state = model.sha_compress_final(state, block, word_bits)
    return state


def verify(params, vk, digest, proof) -> None:
    from sha2cq_tpu.plonk import verify_proof
    from sha2cq_tpu.poly.kzg.strategy import AccumulatorStrategy
    from sha2cq_tpu.utils.transcript import Blake2bRead
    t0 = time.perf_counter()
    ok = verify_proof(params, vk, AccumulatorStrategy(params, rng=random.Random(3)),
                      [[digest]], Blake2bRead(proof)).check()
    log(f"verify: {ok} in {time.perf_counter() - t0:.2f}s")
    assert ok, "proof does not verify"


def _cache_files() -> int:
    from sha2cq_tpu import compile_cache_dir
    return sum(len(fs) for _, _, fs in os.walk(compile_cache_dir()))


def prove_timed(label, params, pk, circuit, digest, seed, card, **kw):
    from sha2cq_tpu.plonk import create_proof
    from sha2cq_tpu.utils.profiling import profiler
    profiler.enable()
    profiler.reset()
    files0 = _cache_files()
    t0 = time.perf_counter()
    proof = create_proof(params, pk, [circuit], [[digest]],
                         rng=random.Random(seed), **kw)
    dt = time.perf_counter() - t0
    log(f"prove {label}: {dt:.2f}s, {len(proof)} B [{card}]")
    log(profiler.report(f"{label} prove phases"))
    t = profiler.timings()
    for key in ("aot_compile", "aot_deser"):
        if key in t:
            log(f"h program {key}: {t[key]:.2f}s [{card}]")
    log(f"compile cache files: {files0} -> {_cache_files()}")
    profiler.disable()
    return proof, dt


def phase_prove(card: str, k: int = PROVE_K, nblocks: int = PROVE_BLOCKS,
                word_bits: int = PROVE_WORD_BITS) -> None:
    from sha2cq_tpu.plonk.prover import default_h_device
    log(f"cut: SHA-256 circuit at {word_bits}-bit words (FIPS is 32); "
        f"k={k}, {nblocks} chained blocks; the layout and device work "
        "are those of the 32-bit circuit, the CQ tables are smaller")
    rng = random.Random(0x5256)
    blocks = [[rng.randrange(1 << word_bits) for _ in range(16)]
              for _ in range(nblocks)]
    circuit, params, vk, pk = sha_setup(word_bits, k, rng.randrange(1 << 250),
                                        blocks)
    digest = circuit.expected_digest()
    assert digest == model_digest(blocks, word_bits), \
        "circuit digest != models/sha/sha256.py"
    log(f"digest (model-checked, {word_bits}-bit words): {digest}")
    assert default_h_device(), "create_proof would not put h on the device"
    proof, _ = prove_timed("cold (device h, compile included)", params, pk,
                           circuit, digest, 7, card)
    verify(params, vk, digest, proof)
    warm, _ = prove_timed("warm (device h)", params, pk, circuit, digest, 7,
                          card)
    assert warm == proof, "warm device proof != cold device proof"
    ref, _ = prove_timed("host-h reference", params, pk, circuit, digest, 7,
                         card, h_device=False)
    assert ref == proof, "device-h proof bytes != host-h reference bytes"
    log("proof bytes: device h == host-h reference")


def phase_fips32(card: str, budget_s: float) -> None:
    """1-block FIPS SHA-256 at k=13, hashlib-checked.  The 32-bit table
    setup runs on this host; if it outlasts budget_s the phase fails after
    printing the per-column times that the setup reports as it goes."""
    import hashlib

    from sha2cq_tpu.models.sha import setup32
    log(f"nproc {os.cpu_count()}")
    rng = random.Random(0x5256)
    message = bytes(rng.randrange(256) for _ in range(55))
    buf = bytearray(message) + b"\x80"
    while len(buf) % 64 != 56:
        buf.append(0)
    buf += (len(message) * 8).to_bytes(8, "big")
    blocks = [[int.from_bytes(buf[off + 4 * i: off + 4 * i + 4], "big")
               for i in range(16)] for off in range(0, len(buf), 64)]
    box = {}

    def build():
        try:
            box["out"] = sha_setup(32, PROVE_K, FIPS32_SECRET, blocks)
        except Exception as e:  # reported below
            box["err"] = e

    t0 = time.perf_counter()
    th = threading.Thread(target=build, daemon=True)
    th.start()
    th.join(budget_s)
    if th.is_alive():
        done = sum(len(fs) for _, _, fs in os.walk(setup32.data_cache_dir())
                   if fs)
        raise RuntimeError(
            f"32-bit table setup unfinished after {budget_s:.0f}s "
            f"({done} cache files written); per-column times above")
    if "err" in box:
        raise box["err"]
    log(f"32-bit setup + keygen: {time.perf_counter() - t0:.1f}s "
        f"on {os.cpu_count()} cores")
    circuit, params, vk, pk = box["out"]
    digest = circuit.expected_digest()
    expect = hashlib.sha256(message).digest()
    assert b"".join(d.to_bytes(4, "big") for d in digest) == expect, \
        "circuit digest != hashlib"
    log(f"digest (hashlib-checked): {expect.hex()}")
    proof, _ = prove_timed("FIPS cold (device h)", params, pk, circuit, digest,
                           7, card)
    verify(params, vk, digest, proof)
    warm, _ = prove_timed("FIPS warm (device h)", params, pk, circuit,
                          digest, 7, card)
    assert warm == proof


# ------------------------------ four cards -----------------------------------

def device_memory(label: str) -> None:
    """Prints bytes in use and peak bytes in use on every device (the CPU
    keeps no such statistics and prints None)."""
    import jax
    for d in jax.devices():
        st = d.memory_stats() or {}
        log(f"{label}: device {d.id} bytes_in_use {st.get('bytes_in_use')} "
            f"peak_bytes_in_use {st.get('peak_bytes_in_use')}")


def shard_bytes(tree) -> dict:
    """{device id: bytes of the tree's array shards held there}."""
    import jax
    per = {}
    for leaf in jax.tree_util.tree_leaves(tree):
        for sh in getattr(leaf, "addressable_shards", ()):
            per[sh.device.id] = per.get(sh.device.id, 0) + sh.data.nbytes
    return per


class ShardedVMProbe:
    """Wraps h_vm.run_program_sharded, the mesh prover's h evaluation, and
    records for each call where its input columns and its output rows are
    held, and each device's bytes in use while the output is live."""

    def __init__(self):
        from sha2cq_tpu.plonk import h_vm
        self.mod, self.orig, self.calls = h_vm, h_vm.run_program_sharded, []

    def __enter__(self):
        def probe(prog, state, consts, scalars, size, mesh):
            import jax
            out = jax.block_until_ready(
                self.orig(prog, state, consts, scalars, size, mesh))
            self.calls.append({
                "advice": shard_bytes(state["advice"]),
                "advice_total": state["advice"].nbytes,
                "out": shard_bytes(out), "out_total": out.nbytes,
                "in_use": {d.id: (d.memory_stats() or {}).get("bytes_in_use")
                           for d in mesh.devices.flat}})
            return out
        self.mod.run_program_sharded = probe
        return self

    def __exit__(self, *exc):
        self.mod.run_program_sharded = self.orig

    def check(self, ndev: int) -> None:
        """Each of the ndev devices holds a proper share of the VM's input
        columns and exactly 1/ndev of its output rows."""
        assert self.calls, "the mesh proof never ran the sharded h VM"
        for c in self.calls:
            log(f"sharded h VM: advice bytes per device {c['advice']} of "
                f"{c['advice_total']}; output bytes per device {c['out']} of "
                f"{c['out_total']}; bytes_in_use {c['in_use']}")
            assert sorted(c["advice"]) == list(range(ndev)) and all(
                0 < b < c["advice_total"] for b in c["advice"].values()), \
                "advice columns not spread over the mesh"
            assert c["out"] == {i: c["out_total"] // ndev
                                for i in range(ndev)}, \
                "h VM output rows not split evenly over the mesh"


def phase_mesh_proof(card: str, ndev: int, k: int = PROVE_K,
                     nblocks: int = PROVE_BLOCKS) -> None:
    from sha2cq_tpu.parallel import distributed as DIST
    mesh = DIST.default_mesh(ndev)
    rng = random.Random(0x5256)
    blocks = [[rng.randrange(1 << PROVE_WORD_BITS) for _ in range(16)]
              for _ in range(nblocks)]
    circuit, params, vk, pk = sha_setup(PROVE_WORD_BITS, k,
                                        rng.randrange(1 << 250), blocks)
    digest = circuit.expected_digest()
    assert digest == model_digest(blocks, PROVE_WORD_BITS)
    one, _ = prove_timed("one card (device h)", params, pk, circuit, digest,
                         7, card)
    with ShardedVMProbe() as probe:
        mesh_proof, _ = prove_timed(f"mesh over {ndev} cards, cold", params,
                                    pk, circuit, digest, 7, card, mesh=mesh)
    probe.check(ndev)
    assert mesh_proof == one, "mesh proof bytes != one-card proof bytes"
    log("proof bytes: mesh == one card")
    verify(params, vk, digest, mesh_proof)
    prove_timed(f"mesh over {ndev} cards, warm", params, pk, circuit, digest,
                7, card, mesh=mesh)
    device_memory("after mesh proofs")


def phase_mesh_kernels(card: str, ndev: int, log_n: int = MESH_LOG_N) -> None:
    import jax.numpy as jnp
    import numpy as np

    from sha2cq_tpu.curves import device as PD
    from sha2cq_tpu.fields import device as D
    from sha2cq_tpu.fields.host import FR_MOD, FR_ROOT_OF_UNITY, FR_S
    from sha2cq_tpu.native_loader import native_fr_ntt_multi
    from sha2cq_tpu.ops import msm as M
    from sha2cq_tpu.ops import ntt as NTT
    from sha2cq_tpu.parallel import distributed as DIST
    from sha2cq_tpu.poly.kzg.params import ParamsKZG
    mesh = DIST.default_mesh(ndev)
    n = 1 << log_n
    omega = pow(FR_ROOT_OF_UNITY, 1 << (FR_S - log_n), FR_MOD)
    buf = _random_fr_buf(n, 7)
    ref = buf.copy()
    assert native_fr_ntt_multi([ref], NTT._host_twiddle_buf(omega, n, FR_MOD),
                               log_n)
    a = jnp.asarray(D.np_pack_buf(buf, D.FR))
    first, warm, out = timed(lambda x: DIST.distributed_ntt(x, omega, log_n,
                                                            mesh), a)
    ok = np.array_equal(D.unpack_buf(out, D.FR), ref)
    log(f"distributed_ntt 2^{log_n} over {ndev}: first {first:.2f}s, warm "
        f"{warm * 1e3:.3f} ms, bit-exact {ok} [{card}]")
    assert ok, "distributed_ntt != native fr_ntt"
    rng = random.Random(5)
    pts = ParamsKZG.setup_from_toxic_waste(log_n, rng.randrange(FR_MOD)).g
    scalars = [rng.randrange(FR_MOD) for _ in range(n)]
    c = 8
    digits = jnp.asarray(M._scalars_to_digits(scalars, c))
    points = PD.pack_affine(pts)
    t0 = time.perf_counter()
    sums = DIST.sharded_msm_window_sums(points, digits, n, mesh, c)
    total = M.fold_window_sums(sums, c)
    log(f"sharded_msm_window_sums 2^{log_n} over {ndev}: "
        f"{time.perf_counter() - t0:.2f}s incl. compile [{card}]")
    device_memory("after sharded kernels")
    assert total == M.msm_host(scalars, pts), "sharded MSM != native Pippenger"
    log("sharded MSM equal to the native Pippenger")


# --------------------------------- main --------------------------------------

def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--fips32", action="store_true",
                      help="prove 1 block of FIPS SHA-256 (32-bit tables, "
                           "built on this host)")
    mode.add_argument("--four-cards", action="store_true",
                      help="run only the 4-GPU mesh proof and sharded kernels")
    ap.add_argument("--fips32-budget", type=float, default=3000.0,
                    help="seconds the 32-bit table setup may take")
    args = ap.parse_args(argv)
    ndev = 4 if args.four_cards else 1

    try:
        card = gpu_name_and_power()
        import jax  # noqa: F401  (fails here when the package env is absent)
        from sha2cq_tpu import native_loader as NL
        if NL.get_lib() is None:
            raise RuntimeError("native C kernels unavailable (no cc?)")
    except Exception:
        traceback.print_exc()
        return 1
    ph = Phases()
    dev = ph.run("device", phase_device, card, ndev)
    if dev is None:
        return 1
    card = card_tag(card)
    if args.four_cards:
        ph.run("mesh_prove", phase_mesh_proof, card, ndev)
        ph.run("mesh_kernels", phase_mesh_kernels, card, ndev)
        dev["count"] = ndev
    elif args.fips32:
        ph.run("fips32", phase_fips32, card, args.fips32_budget)
    else:
        ph.run("mont_mul", check_mont_mul, MONT_MUL_LOG_N, card)
        ph.run("ntt", check_ntts, NTT_LOG_SIZES, card)
        ph.run("msm", check_msm, MSM_LOG_N, card)
        ph.run("prove", phase_prove, card)
    if ph.failed:
        log(f"FAILED phases: {', '.join(ph.failed)}")
        return 1
    log(f"card: {card}")
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
