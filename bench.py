"""Benchmark entry point: prints ONE JSON line.

Headline: the int8-matmul NTT (ops/mxu_ntt.py) at 2^18 over BN254 Fr on
the GPU, the prover's repeated basis-conversion kernel (SURVEY.md §3.2):
median of RUNS warm transforms, each closed by block_until_ready.
vs_baseline compares against the reference's rayon `best_fft` on a server
CPU (~100 ms at 2^18 single-socket — measured class of halo2 v0.2
best_fft; the reference repo itself publishes no numbers and its criterion
benches are disabled, see BASELINE.md).

extra: the device (platform, device_kind, count, nvidia-smi name and power
limit), the butterfly NTT at the same size, the native host MSM at 2^14
(named as host), and a SHA-256 proof (8-bit words, k=13, 64 chained
blocks) with h on the device: cold and warm prove, verify, proof bytes.
Everything runs in this one process.  Without a GPU it exits non-zero and
prints no result.
"""
import json
import random
import sys
import time

import chip_smoke as S

K = 18
RUNS = 20
BASELINE_BEST_FFT_S = 0.100  # reference-class CPU best_fft at 2^18 (see docstring)


def main() -> int:
    import jax
    import numpy as np

    from sha2cq_tpu.fields import device as D, host as H
    from sha2cq_tpu.ops import mxu_ntt as MX
    from sha2cq_tpu.ops import ntt as NTT

    dev = S.check_device(jax.devices())
    extra = {"platform": dev["platform"], "device_kind": dev["kind"],
             "device_count": dev["count"], "card": S.gpu_name_and_power()}

    omega = pow(H.FR_ROOT_OF_UNITY, 1 << (H.FR_S - K), H.FR_MOD)
    a = jax.numpy.asarray(D.np_pack_buf(S._random_fr_buf(1 << K, 0), D.FR))
    first, dt, out = S.timed(lambda x: MX.mxu_ntt(x, omega, K), a, reps=RUNS)
    extra["first_call_s"] = round(first, 3)
    extra["path"] = "int8_matmul"
    _, bdt, ref = S.timed(jax.jit(lambda x: NTT.ntt(x, omega, K)), a, reps=5)
    assert np.array_equal(np.asarray(out), np.asarray(ref))
    extra[f"ntt_butterfly_2e{K}_seconds"] = round(bdt, 6)

    from sha2cq_tpu.curves import host as CH
    from sha2cq_tpu.ops import msm as M
    rng = random.Random(0)
    nm = 1 << 14
    sc = [rng.randrange(H.FR_MOD) for _ in range(nm)]
    pts = [CH.g1_mul(CH.G1_GEN, i + 2) for i in range(64)] * (nm // 64)
    t0 = time.perf_counter()
    M.msm_host(sc, pts)
    extra["msm_host_2e14_s"] = round(time.perf_counter() - t0, 4)

    blocks = [[rng.randrange(256) for _ in range(16)]
              for _ in range(S.PROVE_BLOCKS)]
    circuit, params, vk, pk = S.sha_setup(8, S.PROVE_K, rng.randrange(1 << 250),
                                          blocks)
    digest = circuit.expected_digest()
    assert digest == S.model_digest(blocks, 8)
    card = extra["card"]
    proof, cold = S.prove_timed("cold", params, pk, circuit, digest, 7, card)
    S.verify(params, vk, digest, proof)
    _, warm = S.prove_timed("warm", params, pk, circuit, digest, 7, card)
    extra.update({"sha256_8bit_k13_64blk_prove_cold_s": round(cold, 3),
                  "sha256_8bit_k13_64blk_prove_warm_s": round(warm, 3),
                  "sha256_8bit_proof_bytes": len(proof)})

    print(json.dumps({
        "metric": f"ntt_2e{K}_seconds",
        "value": round(dt, 6),
        "unit": "s",
        "vs_baseline": round(BASELINE_BEST_FFT_S / dt, 3),
        "extra": extra,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
