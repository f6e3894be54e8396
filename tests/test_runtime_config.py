"""Choices the runtime makes from its environment: compile/data cache
placement, the device builders of the matmul-NTT plans, the default h path,
and chip_smoke.py's refusal to run anywhere but on a GPU."""
import os
import random
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import sha2cq_tpu
from sha2cq_tpu.fields import device as D, host as H
from sha2cq_tpu.ops import mxu_ntt as MX

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cache_dir_in_fresh_process(env_dir):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    if env_dir is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_dir
    out = subprocess.run(
        [sys.executable, "-c",
         "import jax, sha2cq_tpu; "
         "print(jax.config.jax_compilation_cache_dir); "
         "print(sha2cq_tpu.compile_cache_dir())"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120,
        check=True)
    return out.stdout.split()


def test_compile_cache_default_is_fixed_in_checkout():
    used, reported = _cache_dir_in_fresh_process(None)
    assert used == reported == os.path.join(ROOT, ".cache", "jax")


def test_compile_cache_follows_env(tmp_path):
    d = str(tmp_path / "jaxcache")
    used, reported = _cache_dir_in_fresh_process(d)
    assert used == reported == d


def test_data_cache_dir(monkeypatch, tmp_path):
    monkeypatch.delenv("SHA2CQ_CACHE", raising=False)
    assert sha2cq_tpu.data_cache_dir("x") == os.path.join(
        ROOT, ".cache", "data", "x")
    monkeypatch.setenv("SHA2CQ_CACHE", str(tmp_path))
    d = sha2cq_tpu.data_cache_dir("mxu_ntt")
    assert d == str(tmp_path / "mxu_ntt") and os.path.isdir(d)


def _omega(k):
    return pow(H.FR_ROOT_OF_UNITY, 1 << (H.FR_S - k), H.FR_MOD)


@pytest.mark.parametrize("m", [8, 16])
def test_digit_matrix_device_build_matches_host(m):
    omega = _omega(m.bit_length() - 1)
    mat, rowsum = MX._dft_digit_matrix_np(m, omega, H.FR_MOD)
    dmat, drow = MX._dft_digit_matrix_dev(m, omega, D.FR)
    assert np.array_equal(np.asarray(dmat), mat)
    assert np.array_equal(np.asarray(drow), rowsum)


@pytest.mark.parametrize("m2,m1", [(8, 4), (16, 8)])
def test_twiddle_tensor_device_build_matches_host(m2, m1):
    omega = _omega((m2 * m1).bit_length() - 1)
    host = MX._twiddle_tensor.__wrapped__(omega, m2, m1, "Fr")
    dev = MX._twiddle_tensor_dev(omega, m2, m1, D.FR)
    assert np.array_equal(np.asarray(dev), np.asarray(host))


@pytest.mark.parametrize("backend,device_built", [("cpu", False),
                                                  ("gpu", True)])
def test_plan_builders_follow_backend(monkeypatch, backend, device_built):
    calls = []
    monkeypatch.setattr(MX.jax, "default_backend", lambda: backend)
    monkeypatch.setattr(MX, "_dft_digit_matrix_dev",
                        lambda *a: calls.append("mat") or (jnp.zeros(1),) * 2)
    monkeypatch.setattr(MX, "_dft_digit_matrix_np",
                        lambda *a: (np.zeros(1), np.zeros(1)))
    monkeypatch.setattr(MX, "_twiddle_tensor_dev",
                        lambda *a: calls.append("tw") or jnp.zeros(1))
    MX._dft_digit_matrix.cache_clear()
    MX._twiddle_tensor.cache_clear()
    try:
        MX._dft_digit_matrix(64, _omega(6), "Fr")
        if device_built:
            MX._twiddle_tensor(_omega(16), 256, 256, "Fr")
    finally:
        MX._dft_digit_matrix.cache_clear()
        MX._twiddle_tensor.cache_clear()
    assert calls == (["mat", "tw"] if device_built else [])


@pytest.mark.parametrize("backend,expect", [("cpu", False), ("gpu", True)])
def test_default_h_device_follows_backend(monkeypatch, backend, expect):
    from sha2cq_tpu.plonk.prover import default_h_device
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    assert default_h_device() is expect


def test_create_proof_default_takes_device_h_off_cpu(monkeypatch):
    """h_device=None resolves through default_h_device; off the CPU that is
    the device path, whose bytes equal the host reference."""
    import tests.test_e2e_cq as E
    from sha2cq_tpu.plonk import create_proof, keygen_pk, keygen_vk
    from sha2cq_tpu.plonk import device_eval as DE
    from sha2cq_tpu.plonk import prover as PR

    rng, srs, t1, t2, params, configs, b0 = E._setup(3)
    circuit = E.MyCircuit(t1, t2)
    vk = keygen_vk(params, circuit)
    pk = keygen_pk(params, configs, b0, vk, circuit)
    host = create_proof(params, pk, [circuit], [[]], rng=random.Random(4))
    built = []
    real = DE.get_h_fn
    monkeypatch.setattr(DE, "get_h_fn",
                        lambda *a, **k: built.append(1) or real(*a, **k))
    monkeypatch.setattr(PR, "default_h_device", lambda: True)
    dev = create_proof(params, pk, [circuit], [[]], rng=random.Random(4))
    assert built and dev == host
    built.clear()
    assert create_proof(params, pk, [circuit], [[]], rng=random.Random(4),
                        h_device=False) == host
    assert not built


class _Dev:
    def __init__(self, platform, kind="NVIDIA H100 80GB HBM3"):
        self.platform, self.device_kind = platform, kind


def test_chip_smoke_refuses_cpu():
    import chip_smoke
    with pytest.raises(RuntimeError, match="not 'gpu'"):
        chip_smoke.check_device(jax.devices())
    with pytest.raises(RuntimeError, match="no devices"):
        chip_smoke.check_device([])
    with pytest.raises(RuntimeError, match="need 4"):
        chip_smoke.check_device([_Dev("gpu")], want_count=4)
    assert chip_smoke.check_device([_Dev("gpu")] * 4, want_count=4) == {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4}


def test_chip_smoke_main_fails_without_card(monkeypatch, capsys):
    import chip_smoke

    def no_smi():
        raise FileNotFoundError("nvidia-smi")
    monkeypatch.setattr(chip_smoke, "gpu_name_and_power", no_smi)
    assert chip_smoke.main([]) == 1
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.parametrize("smi,tag", [
    ("NVIDIA H100 80GB HBM3, 700.00 W", "NVIDIA H100 80GB HBM3, 700.00 W"),
    ("H100, 700.00 W\nH100, 700.00 W", "2 x H100, 700.00 W"),
    ("H100, 700.00 W\nH100, 500.00 W", "H100, 700.00 W; H100, 500.00 W"),
])
def test_chip_smoke_card_tag(smi, tag):
    import chip_smoke
    assert chip_smoke.card_tag(smi) == tag
