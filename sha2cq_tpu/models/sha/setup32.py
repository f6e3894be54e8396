"""Preprocessing for the real SHA-256 circuit (circuit32.py): master
TableSRS, all half/piece/limb table families, per-size configs.

Same shape as setup.py but driven by tables32.build_all_columns; the whole
preprocessed bundle is disk-cached (the 32-bit scheme is ~an hour of
one-time native FK + G2 MSM work across ~52 table columns).
"""
from __future__ import annotations

import hashlib
import os
import pickle
from typing import Dict

from ... import data_cache_dir
from ...fields import host as H
from ...plonk.static_tables import StaticTable, StaticTableValues
from ...poly.kzg.params import TableSRS
from .setup import config_from_s
from .tables32 import HalfScheme, build_all_columns

P = H.FR_MOD


def _cache_file(tag: str) -> str:
    return os.path.join(
        data_cache_dir(), hashlib.sha256(tag.encode()).hexdigest()[:24] + ".pkl")


def _load_srs(srs_len: int, secret: int, cache: bool, progress: bool):
    """TableSRS, disk-cached on (srs_len, secret): the G1/G2 power chains are
    minutes of work at 2^18 and identical across every circuit size k<=18."""
    path = _cache_file(f"sha256_srs_{srs_len}_{secret % P:x}") if cache else None
    if path and os.path.exists(path):
        with open(path, "rb") as f:
            return pickle.load(f)
    if progress:
        import time
        t0 = time.time()
    srs = TableSRS.setup_from_toxic_waste(srs_len - 1, srs_len, secret)
    if progress:
        print(f"  TableSRS ({srs_len}): {time.time() - t0:.1f}s", flush=True)
    if path:
        with open(path + ".tmp", "wb") as f:
            pickle.dump(srs, f, protocol=4)
        os.replace(path + ".tmp", path)
    return srs


def build_sha256_setup(s: HalfScheme, circuit_n: int, secret: int,
                       cache: bool = True, progress: bool = False):
    """Returns (static_tables, configs, b0_g1_bound, srs) for circuit32."""
    cache_path = None
    if cache:
        tag = f"sha256_setup_{s.word_bits}_{circuit_n}_{secret % P:x}"
        cache_path = _cache_file(tag)
        if os.path.exists(cache_path):
            with open(cache_path, "rb") as f:
                return pickle.load(f)

    specs = build_all_columns(s)
    max_size = max(len(next(iter(c.values()))) for c in specs.values())
    srs_len = max(max_size, circuit_n)
    if progress:
        from collections import Counter
        rows = Counter(len(v) for c in specs.values() for v in c.values())
        print(f"  {sum(rows.values())} table columns: "
              + ", ".join(f"{m} of {r} rows" for r, m in sorted(rows.items())),
              flush=True)
    srs = _load_srs(srs_len, secret, cache, progress)

    # per-table checkpointing: each preprocessed column is cached on its own,
    # so an interrupted multi-hour build resumes where it stopped.  The key
    # deliberately EXCLUDES circuit_n: the expensive halves (FK quotient
    # commitments, the G2 table commitment) depend only on the table values
    # and the SRS; only the one-point B0 degree bound [x^{srs-1-(n-2)}]_2
    # does, and that is re-picked from srs.g2 below — so k=13 and k=14
    # setups share one multi-hour table build.
    tdir = None
    if cache_path:
        tdir = os.path.join(
            data_cache_dir(),
            f"sha256_tables_{s.word_bits}_{srs_len}_{secret % P:x}")
        os.makedirs(tdir, exist_ok=True)

    static_tables: Dict[str, Dict[str, StaticTable]] = {}
    sizes = set()
    for fam, columns in specs.items():
        static_tables[fam] = {}
        for comp, values in columns.items():
            sizes.add(len(values))
            tpath = os.path.join(tdir, f"{fam}_{comp}.pkl") if tdir else None
            if tpath and os.path.exists(tpath):
                with open(tpath, "rb") as f:
                    entry = pickle.load(f)
                entry.committed.x_b0_bound = srs.g2[srs_len - 1 - (circuit_n - 2)]
                static_tables[fam][comp] = entry
                continue
            if progress:
                import time
                t0 = time.time()
            tv = StaticTableValues(values, srs.g1)
            committed = tv.commit(srs_len, srs.g2, circuit_n)
            entry = StaticTable(opened=tv, committed=committed)
            static_tables[fam][comp] = entry
            if tpath:
                with open(tpath + ".tmp", "wb") as f:
                    pickle.dump(entry, f, protocol=4)
                os.replace(tpath + ".tmp", tpath)
            if progress:
                print(f"  table {fam}.{comp} ({len(values)} rows): "
                      f"{time.time() - t0:.1f}s", flush=True)

    configs = {size: config_from_s(secret, size) for size in sizes}
    b0_g1_bound = srs.g1[srs_len - circuit_n + 1:]
    result = (static_tables, configs, b0_g1_bound, srs)
    if cache_path:
        with open(cache_path + ".tmp", "wb") as f:
            pickle.dump(result, f, protocol=4)
        os.replace(cache_path + ".tmp", cache_path)
    return result


def save_setup_bundle(path: str, setup) -> None:
    """Write a (static_tables, configs, b0_g1_bound, srs) tuple — as returned
    by build_sha256_setup — to a portable raw-bytes artifact (utils/keyio
    wire format; machine/Python-version independent, unlike the resume
    pickles above).  The reference cannot ship this state at all: it drops
    static tables on key read (plonk.rs:161-163 TODO)."""
    from ...utils import keyio
    data = keyio.write_table_bundle(*setup)
    with open(path + ".tmp", "wb") as f:
        f.write(data)
    os.replace(path + ".tmp", path)


def load_setup_bundle(path: str):
    """Read a bundle written by save_setup_bundle."""
    from ...utils import keyio
    with open(path, "rb") as f:
        return keyio.read_table_bundle(f.read())


def build_mock_tables(s: HalfScheme) -> Dict[str, Dict[str, StaticTable]]:
    """Values-only StaticTables — no FK preprocessing, no commitments.

    MockProver only needs table membership (dev/mock_prover.py checks
    `opened.values`); the 32-bit scheme's tables are hours of group work to
    commit but seconds to enumerate, so this is what a 32-bit mock run uses
    (tests/test_sha256_circuit.py opt-in test)."""
    specs = build_all_columns(s)
    out: Dict[str, Dict[str, StaticTable]] = {}
    for fam, columns in specs.items():
        out[fam] = {}
        for comp, values in columns.items():
            tv = StaticTableValues.__new__(StaticTableValues)
            tv.size = len(values)
            tv.values = [v % P for v in values]
            mapping = {v: i for i, v in enumerate(tv.values)}
            tv.value_index_mapping = mapping if len(mapping) == tv.size else None
            tv.qs = []
            out[fam][comp] = StaticTable(opened=tv, committed=None)
    return out
