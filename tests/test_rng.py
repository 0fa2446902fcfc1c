"""SFC32 RNG tests: bit-exactness vs the numpy twin, known-answer vectors,
draw-order parity of gen_vec, and statistical sanity."""

import numpy as np
import jax.numpy as jnp

from haskell_path_tracer.ops import rng as R


def ref_sfc32_scalar(a, b, c, counter, n):
    """Independent pure-Python SFC32 (masked 32-bit arithmetic)."""
    M = 0xFFFFFFFF
    out = []
    for _ in range(n):
        t = (a + b + counter) & M
        counter = (counter + 1) & M
        a = (b ^ (b >> 9)) & M
        b = (c + ((c << 3) & M)) & M
        c = (((c << 21) | (c >> 11)) + t) & M
        out.append(t)
    return out, (a, b, c, counter)


def test_sfc32_known_answer():
    state = jnp.asarray([[1, 2, 3, 4]], jnp.uint32)
    outs = []
    for _ in range(8):
        o, state = R.sfc32_next(state)
        outs.append(int(o[0]))
    expected, _ = ref_sfc32_scalar(1, 2, 3, 4, 8)
    assert outs == expected


def test_sfc32_matches_numpy_twin():
    rng = np.random.default_rng(42)
    st0 = rng.integers(0, 2**32, size=(64, 4), dtype=np.uint32)
    js, ns = jnp.asarray(st0), st0.copy()
    for _ in range(16):
        jo, js = R.sfc32_next(js)
        no, ns = R.np_sfc32_next(ns)
        np.testing.assert_array_equal(np.asarray(jo), no)
    np.testing.assert_array_equal(np.asarray(js), ns)


def test_gen_vec_draw_order_and_range():
    st0 = np.random.default_rng(7).integers(
        0, 2**32, size=(128, 4), dtype=np.uint32
    )
    v, s1 = R.gen_vec(jnp.asarray(st0))
    nv, ns1 = R.np_gen_vec(st0)
    np.testing.assert_array_equal(np.asarray(v), nv)
    np.testing.assert_array_equal(np.asarray(s1), ns1)
    v = np.asarray(v)
    assert v.min() >= -1.0 and v.max() <= 1.0
    # x is drawn first, y second, z third: verify against scalar reference
    outs, _ = ref_sfc32_scalar(*[int(x) for x in st0[0]], 3)
    expect = [(o >> 8) * (1.0 / (1 << 24)) * 2.0 - 1.0 for o in outs]
    np.testing.assert_allclose(v[0], np.float32(expect), rtol=1e-6)


def test_gen_seeds_deterministic_and_distinct():
    s1 = R.gen_seeds((8, 8), seed=123)
    s2 = R.gen_seeds((8, 8), seed=123)
    s3 = R.gen_seeds((8, 8), seed=124)
    np.testing.assert_array_equal(np.asarray(s1), np.asarray(s2))
    assert not np.array_equal(np.asarray(s1), np.asarray(s3))
    # all per-pixel states distinct
    flat = np.asarray(s1).reshape(-1, 4)
    assert len({tuple(r) for r in flat}) == flat.shape[0]


def test_uniformity():
    state = R.gen_seeds((4096,), seed=0)
    u, _ = R.sfc32_float(state)
    u = np.asarray(u)
    assert 0.0 <= u.min() and u.max() < 1.0
    assert abs(u.mean() - 0.5) < 0.02
    assert abs(u.std() - np.sqrt(1 / 12)) < 0.02


def test_reseed_keeps_color():
    from haskell_path_tracer.render.integrator import make_accumulator

    acc = make_accumulator(8, 8, seed=1)
    acc2 = R.reseed((8, 8), acc, seed=99)
    np.testing.assert_array_equal(np.asarray(acc.color), np.asarray(acc2.color))
    assert not np.array_equal(np.asarray(acc.rng), np.asarray(acc2.rng))


def test_stateless_seeding_warmup_and_uniformity():
    """The stateless sampler's threefry-derived SFC32 states follow the
    same discipline as gen_seeds (12 burn-in rounds),
    and the first draws after warm-up are uniform: mean ~ 0.5 and each
    of 8 histogram octiles within 5 sigma of uniform over 64k draws."""
    import jax.random as jr

    key = jr.PRNGKey(1234)
    states = jr.bits(key, (128, 128, 4), jnp.uint32)
    for _ in range(12):
        _, states = R.sfc32_next(states)
    u, _ = R.sfc32_float(states)
    u = np.asarray(u).ravel()
    n = u.size
    assert abs(u.mean() - 0.5) < 5 * (1.0 / np.sqrt(12 * n))
    counts, _ = np.histogram(u, bins=8, range=(0.0, 1.0))
    expect = n / 8
    sigma = np.sqrt(n * (1 / 8) * (7 / 8))
    assert (np.abs(counts - expect) < 5 * sigma).all(), counts
