"""Device-path prover: h evaluated on device must produce proofs that
verify, and byte-identical transcripts to the host path under the same rng."""
import random

import tests.test_e2e_cq as E
from sha2cq_tpu.plonk import create_proof, keygen_pk, keygen_vk, verify_proof
from sha2cq_tpu.poly.kzg.strategy import AccumulatorStrategy
from sha2cq_tpu.utils.transcript import Blake2bRead


def test_h_device_proof_matches_host():
    K = 3
    rng, srs, t1, t2, params, configs, b0 = E._setup(K)
    circuit = E.MyCircuit(t1, t2)
    vk = keygen_vk(params, circuit)
    pk = keygen_pk(params, configs, b0, vk, circuit)

    rng_a = random.Random(123)
    proof_host = create_proof(params, pk, [circuit], [[]], rng=rng_a)
    rng_b = random.Random(123)
    proof_dev = create_proof(params, pk, [circuit], [[]], rng=rng_b,
                             h_device=True)
    # identical rng + identical h => byte-identical proofs
    assert proof_dev == proof_host

    batcher = verify_proof(params, vk, AccumulatorStrategy(params, rng=rng_a),
                           [[]], Blake2bRead(proof_dev))
    assert batcher.check()


def test_h_vm_matches_chunk_pipeline():
    """The scanned bytecode VM (plonk/h_vm.py, default) and the unrolled
    chunk-jit fallback (SHA2CQ_H_VM=0) must produce byte-identical proofs:
    the VM is a recompilation-free reformulation of the same fold, not a
    different algorithm."""
    import os

    K = 3
    rng, srs, t1, t2, params, configs, b0 = E._setup(K)
    circuit = E.MyCircuit(t1, t2)
    vk = keygen_vk(params, circuit)
    pk = keygen_pk(params, configs, b0, vk, circuit)

    def clear_h_cache():
        # get_h_fn memoizes the built h_fn on pk attributes
        for key in ("_h_fn", "_h_fn_mxu", "_h_fn_auto"):
            if hasattr(pk, key):
                delattr(pk, key)

    old = os.environ.get("SHA2CQ_H_VM")
    try:
        os.environ["SHA2CQ_H_VM"] = "1"
        clear_h_cache()
        proof_vm = create_proof(params, pk, [circuit], [[]],
                                rng=random.Random(7), h_device=True)
        os.environ["SHA2CQ_H_VM"] = "0"
        clear_h_cache()
        proof_chunks = create_proof(params, pk, [circuit], [[]],
                                    rng=random.Random(7), h_device=True)
    finally:
        if old is None:
            os.environ.pop("SHA2CQ_H_VM", None)
        else:
            os.environ["SHA2CQ_H_VM"] = old
        clear_h_cache()

    assert proof_vm == proof_chunks
    batcher = verify_proof(params, vk,
                           AccumulatorStrategy(params, rng=random.Random(7)),
                           [[]], Blake2bRead(proof_vm))
    assert batcher.check()


def test_h_device_mxu_proof_matches_host():
    """Matmul-NTT basis conversions (ops/mxu_ntt.py) threaded through the
    device h-path must stay byte-identical to the host path.  Forced on at
    tiny k (auto only engages at k >= 12) so CI covers the production route
    the real-SHA prover takes on the GPU."""
    K = 3
    rng, srs, t1, t2, params, configs, b0 = E._setup(K)
    circuit = E.MyCircuit(t1, t2)
    vk = keygen_vk(params, circuit)
    pk = keygen_pk(params, configs, b0, vk, circuit)

    rng_a = random.Random(321)
    proof_host = create_proof(params, pk, [circuit], [[]], rng=rng_a)
    rng_b = random.Random(321)
    proof_mxu = create_proof(params, pk, [circuit], [[]], rng=rng_b,
                             h_device=True, h_mxu=True)
    assert proof_mxu == proof_host

    batcher = verify_proof(params, vk, AccumulatorStrategy(params, rng=rng_a),
                           [[]], Blake2bRead(proof_mxu))
    assert batcher.check()


def test_h_device_multi_circuit_matches_host():
    """Two circuit instances in ONE proof through the device h-path: the
    fused program runs once per circuit and the per-circuit quotients are
    y^T-combined on host (linearity of the quotient pipeline) — bytes must
    equal the host evaluator's circuit-major accumulation
    (VERDICT r3 item 8; reference prover.rs:51-60 + evaluation.rs:285-374)."""
    import random as _r

    import tests.test_plonk_api as PA
    from sha2cq_tpu.poly.kzg.params import ParamsKZG

    rng = _r.Random(777)
    s = rng.randrange(PA.P)
    params = ParamsKZG.setup_from_toxic_waste(PA.K, s)
    a1, b1 = PA._inputs()
    a2 = [2, 6, 9]
    b2 = [8, a2[0], 3]
    c1, c2 = PA.ApiCircuit(a1, b1), PA.ApiCircuit(a2, b2)
    inst1 = [a1[0] * b1[0] % PA.P]
    inst2 = [a2[0] * b2[0] % PA.P]

    vk = keygen_vk(params, c1)
    pk = keygen_pk(params, {}, [], vk, c1)
    proof_host = create_proof(params, pk, [c1, c2], [[inst1], [inst2]],
                              rng=_r.Random(5))
    proof_dev = create_proof(params, pk, [c1, c2], [[inst1], [inst2]],
                             rng=_r.Random(5), h_device=True)
    assert proof_dev == proof_host, "multi-circuit device h != host bytes"

    batcher = verify_proof(params, vk, AccumulatorStrategy(params, rng=rng),
                           [[inst1], [inst2]], Blake2bRead(proof_dev))
    assert batcher.check()


def test_prewarm_prover_idempotent_and_usable():
    """prewarm_prover returns one thread per pk (boot-time warm API) and a
    subsequent device-path proof still matches the host path byte for
    byte."""
    from sha2cq_tpu.plonk import create_proof as _cp
    from sha2cq_tpu.plonk import prewarm_prover

    K = 3
    rng, srs, t1, t2, params, configs, b0 = E._setup(K)
    circuit = E.MyCircuit(t1, t2)
    vk = keygen_vk(params, circuit)
    pk = keygen_pk(params, configs, b0, vk, circuit)

    th1 = prewarm_prover(pk, h_mxu=True)
    th2 = prewarm_prover(pk)
    assert th1 is th2
    th1.join(timeout=300)

    proof_host = _cp(params, pk, [circuit], [[]], rng=random.Random(5))
    proof_dev = _cp(params, pk, [circuit], [[]], rng=random.Random(5),
                    h_device=True, h_mxu=True)
    assert proof_dev == proof_host


def test_staged_f_coeff_path_matches_host(monkeypatch):
    """The batched CQ commit phase converts f to coefficients early so the
    prover can stage its device transfer before beta (prover.py h staging).
    Force the batched path at toy size and pin device-path bytes == host."""
    from sha2cq_tpu.plonk import static_lookup as SL

    monkeypatch.setattr(SL, "BATCH_MIN_N", 8)
    K = 3
    rng, srs, t1, t2, params, configs, b0 = E._setup(K)
    circuit = E.MyCircuit(t1, t2)
    vk = keygen_vk(params, circuit)
    pk = keygen_pk(params, configs, b0, vk, circuit)

    proof_host = create_proof(params, pk, [circuit], [[]],
                              rng=random.Random(9))
    proof_dev = create_proof(params, pk, [circuit], [[]],
                             rng=random.Random(9), h_device=True, h_mxu=True)
    assert proof_dev == proof_host
    batcher = verify_proof(params, vk,
                           AccumulatorStrategy(params, rng=random.Random(9)),
                           [[]], Blake2bRead(proof_dev))
    assert batcher.check()


def test_h_coset_streamed_matches_host(monkeypatch):
    """The coset-streamed h path (SHA2CQ_H_COSETS=1: per-coset n-NTTs +
    rotation-closed VM slices, the k>=18 single-chip memory fix) must be
    byte-identical to the host evaluator."""
    monkeypatch.setenv("SHA2CQ_H_COSETS", "1")
    K = 3
    rng, srs, t1, t2, params, configs, b0 = E._setup(K)
    circuit = E.MyCircuit(t1, t2)
    vk = keygen_vk(params, circuit)
    pk = keygen_pk(params, configs, b0, vk, circuit)

    proof_host = create_proof(params, pk, [circuit], [[]],
                              rng=random.Random(13))
    proof_coset = create_proof(params, pk, [circuit], [[]],
                               rng=random.Random(13), h_device=True,
                               h_mxu=True)
    assert proof_coset == proof_host
    batcher = verify_proof(params, vk,
                           AccumulatorStrategy(params, rng=random.Random(13)),
                           [[]], Blake2bRead(proof_coset))
    assert batcher.check()
