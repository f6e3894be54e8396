"""Device (JAX) limb arithmetic vs the host oracle — bit-exact.

The device layer replaces the reference's 4x64 Montgomery field macros
(arithmetic/curves/src/derive/field.rs) with 16x16-bit limb kernels; this
suite pins them to the host big-int implementation on randomized vectors and
edge cases (0, 1, p-1).
"""
import random

import jax
import pytest

from sha2cq_tpu.fields import device as D, host as H

random.seed(3)

_mul_fr = jax.jit(lambda a, b: D.mont_mul(a, b, D.FR))
_add_fr = jax.jit(lambda a, b: D.add(a, b, D.FR))
_sub_fr = jax.jit(lambda a, b: D.sub(a, b, D.FR))
_inv_fr = jax.jit(lambda a: D.inv(a, D.FR))
_mul_fq = jax.jit(lambda a, b: D.mont_mul(a, b, D.FQ))


def _vectors(p, n=33):
    xs = [random.randrange(p) for _ in range(n)]
    xs[:4] = [0, 1, p - 1, p - 2]
    return xs


def test_fr_mul_add_sub():
    p = H.FR_MOD
    xs, ys = _vectors(p), _vectors(p)
    random.shuffle(ys)
    a, b = D.pack(xs, D.FR), D.pack(ys, D.FR)
    assert D.unpack(_mul_fr(a, b), D.FR) == [x * y % p for x, y in zip(xs, ys)]
    assert D.unpack(_add_fr(a, b), D.FR) == [(x + y) % p for x, y in zip(xs, ys)]
    assert D.unpack(_sub_fr(a, b), D.FR) == [(x - y) % p for x, y in zip(xs, ys)]


def test_fq_mul():
    p = H.FQ_MOD
    xs, ys = _vectors(p), _vectors(p)
    a, b = D.pack(xs, D.FQ), D.pack(ys, D.FQ)
    assert D.unpack(_mul_fq(a, b), D.FQ) == [x * y % p for x, y in zip(xs, ys)]


def test_fr_inv():
    p = H.FR_MOD
    xs = _vectors(p, 9)
    a = D.pack(xs, D.FR)
    got = D.unpack(_inv_fr(a), D.FR)
    assert got == [0 if x == 0 else pow(x, p - 2, p) for x in xs]


def test_mont_roundtrip_and_consts():
    xs = _vectors(H.FR_MOD, 8)
    a = D.pack(xs, D.FR, mont=True)
    std = D.from_mont(a, D.FR)
    assert D.unpack(std, D.FR, mont=False) == [x % H.FR_MOD for x in xs]
    back = D.to_mont(std, D.FR)
    assert D.unpack(back, D.FR) == [x % H.FR_MOD for x in xs]
    one = D.ones((4,), D.FR)
    assert D.unpack(one, D.FR) == [1, 1, 1, 1]


def test_select_eq_iszero():
    xs = [0, 5, 0, 7]
    a = D.pack(xs, D.FR)
    assert list(D.is_zero(a)) == [True, False, True, False]
    b = D.pack([0, 5, 1, 6], D.FR)
    assert list(D.eq(a, b)) == [True, True, False, False]
    sel = D.select(D.is_zero(a), b, a)
    assert D.unpack(sel, D.FR) == [0, 5, 1, 7]


@pytest.mark.parametrize("ctx", [D.FR, D.FQ], ids=["fr", "fq"])
def test_mont_mul_forms_bit_identical(ctx):
    """The compact (scan) and unrolled (register) mont_mul forms compute the
    same REDC digit sequence, so every output limb must match, including
    broadcast operands."""
    import jax.numpy as jnp
    p = ctx.p
    xs = _vectors(p, 64)
    ys = list(reversed(_vectors(p, 64)))
    a, b = D.pack(xs, ctx), D.pack(ys, ctx)
    compact = jax.jit(lambda a, b: D._mont_mul_compact(a, b, ctx))
    unrolled = jax.jit(lambda a, b: D._mont_mul_unrolled(a, b, ctx))
    got_c, got_u = compact(a, b), unrolled(a, b)
    assert bool(jnp.all(got_c == got_u))
    assert D.unpack(got_u, ctx) == [x * y % p for x, y in zip(xs, ys)]
    s = b[:, :1]
    assert bool(jnp.all(compact(a, s) == unrolled(a, s)))


@pytest.mark.parametrize("backend", ["cpu", "gpu", "rocm"])
def test_mont_mul_form_choice_by_backend(monkeypatch, backend):
    """mont_mul traces the compact (scan) form whatever the backend."""
    monkeypatch.setattr(jax, "default_backend", lambda: backend)
    a = D.pack([3, 5], D.FR)
    jaxpr = str(jax.make_jaxpr(lambda x: D.mont_mul(x, x, D.FR))(a))
    assert "scan" in jaxpr
    compact = str(jax.make_jaxpr(
        lambda x: D._mont_mul_compact(x, x, D.FR))(a))
    assert jaxpr == compact


def test_unpack_nonmont_native_branch():
    """unpack(mont=False) must agree with the object-fold fallback on the
    NATIVE path (n >= 256): the fr_vec_scale identity constant is 1, not R
    (fr_vec_scale computes vals*c mod p plain — a scale of R silently
    returned x*R for large arrays while small arrays were correct)."""
    import random

    from sha2cq_tpu.fields import device as D
    from sha2cq_tpu.fields import host as H
    rng = random.Random(6)
    xs = [rng.randrange(H.FR_MOD) for _ in range(512)]
    std = D.pack(xs, D.FR, mont=False)
    assert D.unpack(std, D.FR, mont=False) == xs
    # and the Montgomery exit on the same size
    mont = D.pack(xs, D.FR, mont=True)
    assert D.unpack(mont, D.FR, mont=True) == xs
