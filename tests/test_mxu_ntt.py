"""Int8 matmul NTT (ops/mxu_ntt.py) vs the host oracle.

Runs with a small max_m so the digit matrices stay tiny on the CPU backend;
covers the single-matmul base case, one- and two-level four-step recursion,
and the inverse transform round-trip.
"""
import numpy as np
import pytest

from sha2cq_tpu.fields import device as D, host as H
from sha2cq_tpu.ops import ntt as NTT
from sha2cq_tpu.ops.mxu_ntt import mxu_intt, mxu_ntt

P = H.FR_MOD


def _omega(k):
    return pow(H.FR_ROOT_OF_UNITY, 1 << (H.FR_S - k), P)


def _rand(n, seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n)]


@pytest.mark.parametrize("k,max_m", [
    (5, 32),    # single matmul
    (8, 64),    # one four-step level
    (9, 16),    # two levels (512 = 2 * 16 * 16)
    (10, 16),   # tiny residual -> butterfly path (m = 4)
])
def test_mxu_ntt_matches_host(k, max_m):
    n = 1 << k
    omega = _omega(k)
    vals = _rand(n, seed=k)
    got = D.unpack(mxu_ntt(D.pack(vals, D.FR), omega, k, max_m=max_m), D.FR)
    assert got == NTT.ntt_host(vals, omega, P)


def test_mxu_intt_round_trip():
    k, max_m = 8, 64
    n = 1 << k
    omega = _omega(k)
    vals = _rand(n, seed=77)
    fwd = mxu_ntt(D.pack(vals, D.FR), omega, k, max_m=max_m)
    back = mxu_intt(fwd, pow(omega, P - 2, P), k, pow(n, P - 2, P), max_m=max_m)
    assert D.unpack(back, D.FR) == vals


def test_mxu_ntt_worst_case_values():
    """All-max inputs (p-1) stress the digit-plane accumulation bounds."""
    k, max_m = 6, 64
    n = 1 << k
    omega = _omega(k)
    vals = [P - 1] * n
    got = D.unpack(mxu_ntt(D.pack(vals, D.FR), omega, k, max_m=max_m), D.FR)
    assert got == NTT.ntt_host(vals, omega, P)
