"""Unit tests for the AOT executable blob cache policy (device_eval):
compressed blob round-trip and the LRU prune rule (VERDICT r4 #8).

All but the last are pure-filesystem tests — no device, no compile.
"""
import os
import pickle
import time

from sha2cq_tpu.plonk.device_eval import (_AOT_MAGIC, _aot_blob_read,
                                          _aot_blob_write, _aot_load,
                                          _aot_prune)


def test_blob_roundtrip_compressed(tmp_path):
    payload = (b"x" * 100_000, {"tree": [1, 2, 3]}, ("out", 4))
    p = str(tmp_path / "h_all-abc.pkl")
    _aot_blob_write(p, pickle.dumps(payload, protocol=4))
    with open(p, "rb") as f:
        head = f.read(len(_AOT_MAGIC))
    assert head == _AOT_MAGIC  # compressed container by default
    assert os.path.getsize(p) < 100_000  # and actually smaller
    assert _aot_blob_read(p) == payload


def test_blob_roundtrip_uncompressed(tmp_path, monkeypatch):
    monkeypatch.setenv("SHA2CQ_AOT_COMPRESS", "0")
    payload = (b"y" * 1000, None, None)
    p = str(tmp_path / "h_all-def.pkl")
    _aot_blob_write(p, pickle.dumps(payload, protocol=4))
    with open(p, "rb") as f:
        assert f.read(len(_AOT_MAGIC)) != _AOT_MAGIC
    assert _aot_blob_read(p) == payload


def test_blob_read_legacy_plain_pickle(tmp_path):
    # blobs written before the compressed container must still load
    payload = (b"z", "in", "out")
    p = str(tmp_path / "h_all-old.pkl")
    with open(p, "wb") as f:
        pickle.dump(payload, f, protocol=4)
    assert _aot_blob_read(p) == payload


def _mk(d, name, mtime):
    p = os.path.join(d, name)
    with open(p, "wb") as f:
        f.write(b"blob")
    os.utime(p, (mtime, mtime))
    return p


def test_prune_keeps_most_recently_used(tmp_path):
    d = str(tmp_path)
    now = time.time()
    names = [f"h_all-{i:02d}.pkl" for i in range(6)]
    for i, n in enumerate(names):
        _mk(d, n, now - 1000 + i)  # 05 newest ... 00 oldest
    # "use" the oldest blob: utime refresh (what a cache hit does)
    os.utime(os.path.join(d, names[0]), (now + 10, now + 10))
    _mk(d, "unrelated.pkl", now - 5000)  # non-h_all files are untouched
    _aot_prune(d, keep=3)
    left = sorted(f for f in os.listdir(d) if f.startswith("h_all-"))
    # survivors: the refreshed 00, plus the two newest by mtime (04, 05)
    assert left == [names[0], names[4], names[5]]
    assert os.path.exists(os.path.join(d, "unrelated.pkl"))


def test_prune_env_default(tmp_path, monkeypatch):
    d = str(tmp_path)
    now = time.time()
    for i in range(10):
        _mk(d, f"h_all-{i:02d}.pkl", now - 100 + i)
    monkeypatch.setenv("SHA2CQ_AOT_KEEP", "4")
    _aot_prune(d)
    assert sum(f.startswith("h_all-") for f in os.listdir(d)) == 4


def test_load_runs_one_device_blob_in_multidevice_process(tmp_path):
    """A blob compiled for one device must load onto one device even when
    the process sees several (the suite runs on 8 CPU devices): loaded onto
    all of them, its first call expects one shard per device and fails."""
    import jax
    import jax.numpy as jnp
    from jax.experimental.serialize_executable import serialize
    assert len(jax.devices()) > 1
    x = jnp.arange(8, dtype=jnp.uint32)
    exe = jax.jit(lambda a: a * 3 + 1).lower(x).compile()
    p = str(tmp_path / "h_all-dev.pkl")
    _aot_blob_write(p, pickle.dumps(serialize(exe), protocol=4))
    loaded = _aot_load(p)
    assert loaded(x).tolist() == [3 * i + 1 for i in range(8)]
