"""sha2cq_tpu: a halo2-style proving stack (KZG on BN254, PLONK with CQ
static lookups, SHA2-on-CQ circuits) built on JAX/XLA, with native C host
kernels.  The accelerator path runs on an NVIDIA GPU.

Capability map vs the reference (aleph-zero-foundation/sha2-on-cq-halo2):
  fields/, curves/   <- arithmetic/curves (halo2curves)
  ops/               <- halo2_proofs/src/arithmetic.rs hot kernels (NTT, MSM)
  poly/              <- halo2_proofs/src/poly (domain, KZG, GWC/SHPLONK)
  plonk/             <- halo2_proofs/src/plonk (IR, keygen, prover, verifier,
                        permutation, lookup, static_lookup/CQ, vanishing)
  circuit/, dev/     <- halo2_proofs/src/circuit + dev (layouter, MockProver)
  models/            <- sha/, sha-reference (tables + circuits)
  parallel/          <- multi-device sharding (the rayon analogue, done with
                        jax.sharding meshes + collectives)
  utils/             <- transcript, serde, rng
"""
import os

import jax

# Everything the package writes lives inside the checkout, in a directory
# .gitignore lists: the compile cache (unless JAX_COMPILATION_CACHE_DIR names
# one) and the data caches (tables, digit matrices, packed bases; SHA2CQ_CACHE
# moves them).
CACHE_ROOT = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".cache")


def data_cache_dir(*sub: str) -> str:
    """Directory for precomputed data (not compiled code), created on use."""
    d = os.path.join(os.environ.get("SHA2CQ_CACHE")
                     or os.path.join(CACHE_ROOT, "data"), *sub)
    os.makedirs(d, exist_ok=True)
    return d


def compile_cache_dir() -> str:
    """JAX's persistent compile cache: JAX_COMPILATION_CACHE_DIR when set
    (JAX reads it itself), else a fixed path in the checkout — the path is
    part of the cache key, so it must not move between runs."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or os.path.join(CACHE_ROOT, "jax"))


if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    os.makedirs(compile_cache_dir(), exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
