"""Prover scaling benchmark: host vs device h-path at larger k.

Synthetic circuit: one multiplication gate + a dynamic range lookup filling
all usable rows — the evaluate_h/NTT-bound regime where the device path
engages.

Usage: python benchmarks/prove_bench.py [k] [rows_log2]
"""
import json
import os
import random
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sha2cq_tpu.circuit import Value
from sha2cq_tpu.fields.host import FR_MOD
from sha2cq_tpu.plonk import (ConstraintSystem, create_proof, keygen_pk,
                              keygen_vk, verify_proof)
from sha2cq_tpu.poly.kzg.params import ParamsKZG
from sha2cq_tpu.poly.kzg.strategy import AccumulatorStrategy
from sha2cq_tpu.utils.transcript import Blake2bRead

P = FR_MOD


def make_circuit(n_rows: int, table_bits: int = 8):
    class BenchCircuit:
        @classmethod
        def configure(cls, meta: ConstraintSystem):
            a = meta.advice_column()
            b = meta.advice_column()
            c = meta.advice_column()
            q = meta.fixed_column()
            table = meta.lookup_table_column()
            meta.create_gate("mul", lambda cells: [
                cells.query_fixed(q, 0)
                * (cells.query_advice(a, 0) * cells.query_advice(b, 0)
                   - cells.query_advice(c, 0))])
            meta.lookup("range", lambda cells: [
                (cells.query_advice(a, 0), table)])
            return {"a": a, "b": b, "c": c, "q": q, "table": table}

        def synthesize(self, cfg, layouter):
            rng = random.Random(7)

            def fill(table):
                for i in range(1 << table_bits):
                    table.assign_cell(cfg["table"], i, Value.known(i))
            layouter.assign_table("t", fill)

            def assign(region):
                for i in range(n_rows):
                    av = rng.randrange(1 << table_bits)
                    bv = rng.randrange(P)
                    region.assign_fixed(cfg["q"], i, Value.known(1))
                    region.assign_advice(cfg["a"], i, Value.known(av))
                    region.assign_advice(cfg["b"], i, Value.known(bv))
                    region.assign_advice(cfg["c"], i, Value.known(av * bv % P))
            layouter.assign_region("rows", assign)

    return BenchCircuit()


def main():
    k = int(sys.argv[1]) if len(sys.argv) > 1 else 12
    n_rows = 1 << (int(sys.argv[2]) if len(sys.argv) > 2 else k - 1)
    rng = random.Random(17)
    s = rng.randrange(P)

    t0 = time.time()
    params = ParamsKZG.setup_from_toxic_waste(k, s)
    print(f"setup k={k}: {time.time()-t0:.1f}s")

    circuit = make_circuit(n_rows)
    t0 = time.time()
    vk = keygen_vk(params, circuit)
    pk = keygen_pk(params, {}, [], vk, circuit)
    print(f"keygen: {time.time()-t0:.1f}s")

    results = {}
    for mode, kwargs in (("host", {}), ("device", {"h_device": True}),
                         ("device_warm", {"h_device": True})):
        t0 = time.time()
        proof = create_proof(params, pk, [circuit], [[]],
                             rng=random.Random(1), **kwargs)
        results[mode] = round(time.time() - t0, 2)
        print(f"prove[{mode}]: {results[mode]}s  proof={len(proof)}B")

    t0 = time.time()
    ok = verify_proof(params, vk, AccumulatorStrategy(params, rng=rng), [[]],
                      Blake2bRead(proof)).check()
    results["verify"] = round(time.time() - t0, 2)
    print(f"verify: {results['verify']}s ok={ok}")
    assert ok
    print(json.dumps({"k": k, **results}))


if __name__ == "__main__":
    main()
