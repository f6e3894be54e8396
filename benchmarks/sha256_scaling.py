"""Multi-block SHA-256 scaling table (VERDICT r2 #8): prove time vs block
count at fixed k, device h path, ONE process (programs load once).

Each block count proves twice: the first pays any per-shape program load,
the second is the steady-state rate.  Proof size must stay flat and prove
time sub-linear in blocks (the h fold, conversions and commitments are
fixed-size in n = 2^k; only witness synthesis and instance handling scale
with blocks).

Usage: python benchmarks/sha256_scaling.py [k] [blocks...]
  default: k=13, blocks 1 16 64
"""
import hashlib
import json
import os
import random
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from sha256_bench import pad_message
from sha2cq_tpu.models.sha.circuit32 import BLOCK_ROWS, Sha256Circuit
from sha2cq_tpu.models.sha.setup32 import build_sha256_setup
from sha2cq_tpu.models.sha.tables32 import SCHEME32
from sha2cq_tpu.plonk import create_proof, keygen_pk, keygen_vk, verify_proof
from sha2cq_tpu.poly.kzg.params import ParamsKZG
from sha2cq_tpu.poly.kzg.strategy import AccumulatorStrategy
from sha2cq_tpu.plonk.prover import default_h_device
from sha2cq_tpu.utils.transcript import Blake2bRead

PINNED_S = 0x2b068e00660fd714ab61695867925740388c0d300215adf8c964f5d93e9a76e7


def main():
    k = int(sys.argv[1]) if len(sys.argv) > 1 else 13
    blocks_list = [int(b) for b in sys.argv[2:]] or [1, 16, 64]
    h_dev = default_h_device()

    t0 = time.time()
    tables, configs, b0s, _ = build_sha256_setup(SCHEME32, 1 << k, PINNED_S)
    params = ParamsKZG.setup_from_toxic_waste(k, PINNED_S)
    print(f"setup {time.time()-t0:.1f}s (cached tables)", flush=True)

    rows = []
    for nb in blocks_list:
        assert nb * BLOCK_ROWS + 7 < (1 << k), f"{nb} blocks won't fit k={k}"
        msg_len = nb * 64 - 9
        msg = bytes(random.Random(0x5256 + nb).randrange(256)
                    for _ in range(msg_len))
        pblocks = pad_message(msg)
        assert len(pblocks) == nb

        t0 = time.time()
        circuit = Sha256Circuit(pblocks, tables)
        digest = circuit.expected_digest()
        assert b"".join(d.to_bytes(4, "big") for d in digest) == \
            hashlib.sha256(msg).digest()
        t_wit = time.time() - t0

        t0 = time.time()
        vk = keygen_vk(params, circuit)
        pk = keygen_pk(params, configs, b0s, vk, circuit)
        t_keygen = time.time() - t0

        times = []
        proof = None
        for i in range(2):
            t0 = time.time()
            proof = create_proof(params, pk, [circuit], [[digest]],
                                 rng=random.Random(7), h_device=h_dev)
            times.append(round(time.time() - t0, 2))
        t0 = time.time()
        ok = verify_proof(params, vk,
                          AccumulatorStrategy(params, rng=random.Random(8)),
                          [[digest]], Blake2bRead(proof)).check()
        t_verify = round(time.time() - t0, 2)
        assert ok
        row = {"blocks": nb, "k": k, "msg_bytes": msg_len,
               "witness_s": round(t_wit, 2), "keygen_s": round(t_keygen, 2),
               "prove_cold_s": times[0], "prove_warm_s": times[1],
               "verify_s": t_verify, "proof_bytes": len(proof),
               "h_device": h_dev}
        rows.append(row)
        print(json.dumps(row), flush=True)

    print("SCALING:", json.dumps(rows))


if __name__ == "__main__":
    main()
