"""REAL SHA-256 proof benchmark: FIPS-180-4, 32-bit words, hashlib-checked.

Proves: the committed message hashes (with standard SHA padding) to the
public digest.  The digest is cross-checked against hashlib before proving
and the proof verifies through the full CQ+PLONK+KZG pipeline.

Usage: python benchmarks/sha256_bench.py [nblocks] [k]
  nblocks=1 (default): one 64-byte block (55-byte message + padding), k=7
  nblocks=64: 4096-byte padded message (64 blocks chained), k=13

The 32-bit table setup (~52 CQ table columns, up to 2^18 rows) is a
one-time cost cached in the data cache (sha2cq_tpu.data_cache_dir).  h runs
on the device whenever JAX's default backend is not the CPU.
"""
import hashlib
import json
import os
import random
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sha2cq_tpu.fields.host import FR_MOD
from sha2cq_tpu.models.sha import sha256 as model
from sha2cq_tpu.models.sha.circuit32 import BLOCK_ROWS, Sha256Circuit
from sha2cq_tpu.models.sha.setup32 import build_sha256_setup
from sha2cq_tpu.models.sha.tables32 import SCHEME32
from sha2cq_tpu.plonk import create_proof, keygen_pk, keygen_vk, verify_proof
from sha2cq_tpu.plonk.prover import default_h_device
from sha2cq_tpu.poly.kzg.params import ParamsKZG
from sha2cq_tpu.poly.kzg.strategy import AccumulatorStrategy
from sha2cq_tpu.utils.profiling import profiler
from sha2cq_tpu.utils.transcript import Blake2bRead

P = FR_MOD


def pad_message(message: bytes) -> list:
    """FIPS padding -> list of 16-word (32-bit) blocks."""
    length = len(message) * 8
    buf = bytearray(message)
    buf.append(0x80)
    while len(buf) % 64 != 56:
        buf.append(0)
    buf += length.to_bytes(8, "big")
    blocks = []
    for off in range(0, len(buf), 64):
        blocks.append([int.from_bytes(buf[off + 4 * i: off + 4 * i + 4], "big")
                       for i in range(16)])
    return blocks


def main():
    nblocks = int(sys.argv[1]) if len(sys.argv) > 1 else 1
    # pinned test-only toxic waste, independent of the message length, so
    # every block count shares one cached table setup (the value is what the
    # original single-block run drew — the 110-minute table cache keys on it)
    PINNED_S = 0x2b068e00660fd714ab61695867925740388c0d300215adf8c964f5d93e9a76e7
    rng = random.Random(0x5256)
    msg_len = nblocks * 64 - 9   # fills exactly nblocks padded blocks
    message = bytes(rng.randrange(256) for _ in range(msg_len))
    blocks = pad_message(message)
    assert len(blocks) == nblocks
    rows = nblocks * BLOCK_ROWS
    k = max(7, (rows + 7).bit_length())
    if len(sys.argv) > 2:
        k = int(sys.argv[2])
    print(f"message {msg_len} B -> {nblocks} block(s), {rows} rows, k={k}")

    stats = {"scheme": "fips_sha256", "blocks": nblocks, "k": k}
    s = PINNED_S

    t0 = time.time()
    tables, configs, b0, srs = build_sha256_setup(SCHEME32, 1 << k, s, progress=True)
    params = ParamsKZG.setup_from_toxic_waste(k, s)
    stats["setup_s"] = round(time.time() - t0, 1)
    print("setup:", stats["setup_s"], "s; table sizes:", sorted(configs), flush=True)

    circuit = Sha256Circuit(blocks, tables)
    digest = circuit.expected_digest()
    expect = hashlib.sha256(message).digest()
    assert b"".join(d.to_bytes(4, "big") for d in digest) == expect, \
        "circuit digest != hashlib"
    print("digest (hashlib-checked):", expect.hex())

    t0 = time.time()
    vk = keygen_vk(params, circuit)
    pk = keygen_pk(params, configs, b0, vk, circuit)
    stats["keygen_s"] = round(time.time() - t0, 1)
    print("keygen:", stats["keygen_s"], "s", flush=True)

    h_device = default_h_device()
    stats["h_device"] = h_device
    multiopen = os.environ.get("SHA2CQ_MULTIOPEN", "gwc")
    stats["multiopen"] = multiopen
    profiler.enable()
    t0 = time.time()
    proof = create_proof(params, pk, [circuit], [[digest]], rng=rng,
                         h_device=h_device, multiopen=multiopen)
    stats["prove_s"] = round(time.time() - t0, 1)
    stats["proof_bytes"] = len(proof)
    print("prove:", stats["prove_s"], "s; proof:", len(proof), "B")
    print(profiler.report())

    t0 = time.time()
    ok = verify_proof(params, vk, AccumulatorStrategy(params, rng=rng),
                      [[digest]], Blake2bRead(proof),
                      multiopen=multiopen).check()
    stats["verify_s"] = round(time.time() - t0, 1)
    print("verify:", ok, stats["verify_s"], "s")
    assert ok

    if os.environ.get("SHA2CQ_BENCH_WARM", "0") == "1" and h_device:
        # second prove in the same process: every device program is loaded,
        # so this is the production prover's steady-state rate
        profiler.reset()
        t0 = time.time()
        proof_w = create_proof(params, pk, [circuit], [[digest]],
                               rng=random.Random(7), h_device=True,
                               multiopen=multiopen)
        stats["prove_warm_s"] = round(time.time() - t0, 2)
        print(profiler.report("warm prove phases"))
        assert len(proof_w) == len(proof)
        if os.environ.get("SHA2CQ_BENCH_BOTH_MULTIOPEN", "0") == "1":
            # one more warm prove under the OTHER multiopen scheme, so one
            # bench run reports both (GWC = my_test parity default;
            # SHPLONK = the native-fold fast path)
            other = "shplonk" if multiopen == "gwc" else "gwc"
            profiler.reset()
            t0 = time.time()
            proof_o = create_proof(params, pk, [circuit], [[digest]],
                                   rng=random.Random(7), h_device=True,
                                   multiopen=other)
            stats[f"prove_warm_{other}_s"] = round(time.time() - t0, 2)
            ok_o = verify_proof(params, vk,
                                AccumulatorStrategy(params, rng=rng),
                                [[digest]], Blake2bRead(proof_o),
                                multiopen=other).check()
            assert ok_o
    print(json.dumps(stats))


if __name__ == "__main__":
    main()
