"""Preprocessing for the SHA2-on-CQ circuit: master TableSRS, the nine
column-table families, and per-size StaticTableConfigs.

All tables are committed against one master SRS (sized to the largest table)
so every lookup argument shares the b0 degree-bound basis; each distinct
table size gets its own Lagrange/opening-at-0 config (keygen_pk's
static_table_configs map, reference my_test.rs:197-205 generalized to many
sizes).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from ...curves import host as CH
from ...fields import host as H
from ...plonk.static_tables import StaticTable, StaticTableConfig, StaticTableValues
from ...poly.kzg.params import TableSRS, _lagrange_basis_from_s, _omega_for_k
from .tables import (Limbs, create_ch_table, create_decomposition_table,
                     create_limb_ch_table, create_limb_maj_table,
                     create_maj_table, create_rot0_table, create_rot1_table,
                     create_ssig0_table, create_ssig1_table)

P = H.FR_MOD


def _column_tables(rows: List[Tuple[int, int, int, int]], order=("x", "y", "z", "a")):
    """Quadruple rows -> per-column value lists keyed by component name.
    `order` maps tuple positions to component names; 'a' is the output/f
    column (kept as component id 'a' to match circuit.table_ids)."""
    cols = {name: [] for name in order}
    for row in rows:
        for name, v in zip(order, row):
            cols[name].append(int(v))
    return cols


def config_from_s(s: int, size: int) -> StaticTableConfig:
    """Per-size Lagrange + opening-at-0 bases from toxic waste (batched on
    the native kernels; the Python loop was minutes at 2^19)."""
    from ...native_loader import native_batch_scalar_mul

    g1_lagrange = _lagrange_basis_from_s(s, size)
    k = size.bit_length() - 1
    omega_inv = pow(_omega_for_k(k), P - 2, P)
    n_inv = pow(size, P - 2, P)
    # [x^{size-1}]_1 * (1/size)
    last_scaled = CH.g1_mul(CH.G1_GEN, pow(s, size - 1, P) * n_inv % P)
    neg_last = CH.g1_neg(last_scaled)
    w_pows = [1] * size
    for i in range(1, size):
        w_pows[i] = w_pows[i - 1] * omega_inv % P
    scaled = native_batch_scalar_mul(
        [CH.jac_from_affine(p) for p in g1_lagrange], w_pows)
    if scaled is None:
        scaled_aff = [CH.g1_mul(g1_lagrange[i], w_pows[i]) for i in range(size)]
    else:
        scaled_aff = CH.jac_batch_to_affine(scaled)
    opening = [CH.g1_add(pt, neg_last) for pt in scaled_aff]
    zv_g1 = CH.g1_mul(CH.G1_GEN, (pow(s, size, P) - 1) % P)
    xn1_g1 = CH.g1_mul(CH.G1_GEN, pow(s, size - 1, P))
    return StaticTableConfig(size, g1_lagrange, opening,
                             zv_g1=zv_g1, xn1_g1=xn1_g1)


def build_sha_setup(l: Limbs, circuit_n: int, s: int, cache: bool = True):
    """Returns (static_tables, configs, b0_g1_bound, srs).

    static_tables: short-name -> {component -> StaticTable} for the circuit.

    With cache=True the whole preprocessed bundle is pickled under the
    data cache (sha2cq_tpu.data_cache_dir) keyed by (limb scheme, circuit
    size, toxic-waste hash): the 16-bit-scheme FK preprocessing is minutes of one-time native
    compute that every prover run should not repay.  (The cache holds
    test/toxic-waste setups; a production ceremony would ship these as
    artifacts through utils/keyio.)
    """
    import hashlib
    import os
    import pickle

    cache_path = None
    if cache:
        from ... import data_cache_dir
        cache_dir = data_cache_dir()
        tag = f"sha_setup_{l.first}_{l.second}_{circuit_n}_{s % P:x}"
        cache_path = os.path.join(
            cache_dir, hashlib.sha256(tag.encode()).hexdigest()[:24] + ".pkl")
        if os.path.exists(cache_path):
            with open(cache_path, "rb") as f:
                return pickle.load(f)

    result = _build_sha_setup_uncached(l, circuit_n, s, cache_path)
    if cache_path:
        with open(cache_path + ".tmp", "wb") as f:
            pickle.dump(result, f, protocol=4)
        os.replace(cache_path + ".tmp", cache_path)
    return result


def _build_sha_setup_uncached(l: Limbs, circuit_n: int, s: int,
                              cache_path: str = None):
    w = l.word_len
    specs = {
        "dsum": (_column_tables(create_decomposition_table(l, w + 3), ("a", "x", "y", "z"))),
        "rot0": (_column_tables(create_rot0_table(l))),
        "rot1": (_column_tables(create_rot1_table(l))),
        "ssig0": (_column_tables(create_ssig0_table(l))),
        "ssig1": (_column_tables(create_ssig1_table(l))),
        "majf": (_column_tables(create_limb_maj_table(l.first))),
        "majs": (_column_tables(create_limb_maj_table(l.second))),
        "chf": (_column_tables(create_limb_ch_table(l.first))),
        "chs": (_column_tables(create_limb_ch_table(l.second))),
    }
    max_size = max(len(c["a"]) for c in specs.values())
    srs_len = max(max_size, circuit_n)
    srs = TableSRS.setup_from_toxic_waste(srs_len - 1, srs_len, s)

    import os
    import pickle
    tdir = None
    if cache_path:
        tdir = cache_path + ".tables"
        os.makedirs(tdir, exist_ok=True)

    static_tables: Dict[str, Dict[str, StaticTable]] = {}
    sizes = set()
    for tname, columns in specs.items():
        static_tables[tname] = {}
        size = len(columns["a"])
        sizes.add(size)
        for comp, values in columns.items():
            tpath = os.path.join(tdir, f"{tname}_{comp}.pkl") if tdir else None
            if tpath and os.path.exists(tpath):
                with open(tpath, "rb") as f:
                    static_tables[tname][comp] = pickle.load(f)
                continue
            tv = StaticTableValues(values, srs.g1)
            committed = tv.commit(srs_len, srs.g2, circuit_n)
            entry = StaticTable(opened=tv, committed=committed)
            static_tables[tname][comp] = entry
            if tpath:
                with open(tpath + ".tmp", "wb") as f:
                    pickle.dump(entry, f, protocol=4)
                os.replace(tpath + ".tmp", tpath)

    configs = {size: config_from_s(s, size) for size in sizes}
    b0_g1_bound = srs.g1[srs_len - circuit_n + 1:]
    return static_tables, configs, b0_g1_bound, srs
