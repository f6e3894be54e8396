"""CQ standalone at a 2^20 table — BASELINE.json config #3.

The point of CQ (cached quotients) is prover cost independent of table size
after preprocessing (reference static_lookup.rs:107-119 — which is O(N^2)
group work as written there, with FK noted as a TODO; this framework's FK
preprocessing is O(N log N) native group-NTT work, static_tables.py).

This bench:
  1. builds a TableSRS to N = 2^20 and FK-preprocesses ONE 2^20-row range
     table (values = 0..N-1), both resumable via pickle caches;
  2. round-trips the preprocessed table through the keyio raw-bytes bundle
     (the reference DROPS static tables on key read, plonk.rs:161-163);
  3. proves a k=6 circuit whose single constraint is a static lookup into
     that table, and the SAME circuit against a 2^16 table — the marginal
     prove cost must not grow with N.

Usage: python benchmarks/cq2e20_bench.py [log2_N] [k]
  (defaults 20 and 6; pass 16 to only run the small-table row)
"""
import json
import os
import pickle
import random
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from sha2cq_tpu.circuit import Value
from sha2cq_tpu.curves import host as CH
from sha2cq_tpu.fields.host import FR_MOD
from sha2cq_tpu.plonk import (ConstraintSystem, StaticTable, StaticTableConfig,
                              StaticTableId, StaticTableValues, create_proof,
                              keygen_pk, keygen_vk, verify_proof)
from sha2cq_tpu.poly.kzg.params import ParamsKZG, TableSRS
from sha2cq_tpu.poly.kzg.strategy import AccumulatorStrategy
from sha2cq_tpu.utils.transcript import Blake2bRead

P = FR_MOD

# pinned test-only toxic waste (cache key; same spirit as sha256_bench)
PINNED_S = 0x1c92f8d51a2f3b7e9d0c5a6b4e8f7210fedcba9876543210123456789abcdef1


def _cache_dir():
    from sha2cq_tpu import data_cache_dir
    return data_cache_dir()


def _cached(tag, build, progress=True):
    path = os.path.join(_cache_dir(), f"cq20_{tag}.pkl")
    if os.path.exists(path):
        with open(path, "rb") as f:
            return pickle.load(f), 0.0
    t0 = time.time()
    obj = build()
    dt = time.time() - t0
    if progress:
        print(f"  built {tag}: {dt:.1f}s", flush=True)
    with open(path + ".tmp", "wb") as f:
        pickle.dump(obj, f, protocol=4)
    os.replace(path + ".tmp", path)
    return obj, dt


class RangeCircuit:
    """One advice column; every usable row must be < N via one CQ lookup."""

    def __init__(self, values, table):
        self.values = values
        self.table = table

    @classmethod
    def configure(cls, meta: ConstraintSystem):
        advice = meta.advice_column()
        meta.lookup_static("range", lambda cells: [
            (cells.query_advice(advice, 0), StaticTableId("range_table")),
        ])
        return advice

    def synthesize(self, config, layouter):
        layouter.register_static_table(StaticTableId("range_table"), self.table)

        def assign(region):
            for i, v in enumerate(self.values):
                region.assign_advice(config, i, Value.known(v))

        layouter.assign_region("rows", assign)


def run_config(logN: int, k: int, s: int, stats: dict) -> None:
    N = 1 << logN
    label = f"2e{logN}"
    srs, srs_s = _cached(
        f"srs_{logN}_{s % P:x}",
        lambda: TableSRS.setup_from_toxic_waste(N - 1, N, s))
    print(f"TableSRS N={N}: {'cached' if srs_s == 0 else f'{srs_s:.1f}s'}",
          flush=True)

    def build_table():
        tv = StaticTableValues(list(range(N)), srs.g1)  # FK preprocessing
        committed = tv.commit(len(srs.g1), srs.g2, 1 << k)
        return StaticTable(opened=tv, committed=committed)

    table, tbl_s = _cached(f"table_{logN}_{s % P:x}", build_table)
    stats[f"setup_srs_s_{label}"] = round(srs_s, 1)
    stats[f"setup_fk_table_s_{label}"] = round(tbl_s, 1)

    # keyio bundle round trip: the shippable-artifact path the reference
    # lacks entirely (its read stubs static tables with empty maps)
    from sha2cq_tpu.utils import keyio
    configs = {N: StaticTableConfig(
        N, srs.g1_lagrange, srs.g_lagrange_opening_at_0,
        zv_g1=CH.g1_add(srs.g1_xn, CH.g1_neg(srs.g1[0])),
        xn1_g1=srs.g1[N - 1])}
    b0_g1_bound = srs.g1[len(srs.g1) - (1 << k) + 1:]
    t0 = time.time()
    blob = keyio.write_table_bundle(
        {"range": {"i": table}}, configs, b0_g1_bound, srs)
    tables2, configs2, b02, _srs2 = keyio.read_table_bundle(blob)
    stats[f"keyio_roundtrip_s_{label}"] = round(time.time() - t0, 1)
    stats[f"keyio_bundle_mb_{label}"] = round(len(blob) / 1e6, 1)
    table = tables2["range"]["i"]
    configs = configs2
    b0_g1_bound = b02

    params = ParamsKZG.setup_from_toxic_waste(k, s)
    rng = random.Random(0xC0)
    n_rows = (1 << k) - 8
    values = [rng.randrange(N) for _ in range(n_rows)]
    circuit = RangeCircuit(values, table)

    vk = keygen_vk(params, circuit)
    pk = keygen_pk(params, configs, b0_g1_bound, vk, circuit)

    best = None
    for _ in range(3):
        t0 = time.time()
        proof = create_proof(params, pk, [circuit], [[]],
                             rng=random.Random(7))
        dt = time.time() - t0
        best = dt if best is None else min(best, dt)
    t0 = time.time()
    ok = verify_proof(params, vk,
                      AccumulatorStrategy(params, rng=random.Random(9)),
                      [[]], Blake2bRead(proof)).check()
    assert ok, "verification failed"
    stats[f"prove_s_{label}"] = round(best, 3)
    stats[f"verify_s_{label}"] = round(time.time() - t0, 3)
    stats[f"proof_bytes_{label}"] = len(proof)
    print(f"N={N}: prove {best:.3f}s, proof {len(proof)} B (k={k})",
          flush=True)


def main():
    logN = int(sys.argv[1]) if len(sys.argv) > 1 else 20
    k = int(sys.argv[2]) if len(sys.argv) > 2 else 6
    stats = {"bench": "cq_standalone", "k": k}
    # small-table row first: proves the circuit shape cheaply and gives the
    # marginal-cost comparison point
    run_config(16, k, PINNED_S, stats)
    if logN > 16:
        run_config(logN, k, PINNED_S, stats)
    print(json.dumps(stats))


if __name__ == "__main__":
    main()
