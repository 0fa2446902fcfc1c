"""Counter-based per-pixel RNG: SFC32 in pure JAX uint32 ops.

The reference threads a per-pixel SFC32 generator state through the whole
computation (`sfc-random-accelerate`, used at
upstream src/Scene/Objects.hs:36 and upstream src/Util.hs:110-135).
This module reimplements SFC32 on uint32 arrays so that

  * every pixel/ray carries its own [4]-word state (a, b, c, counter) and
    advances it locally — embarrassingly parallel, no cross-lane traffic;
  * the parity harness can match the reference's draw structure: `gen_vec`
    draws three floats in x, y, z order exactly like `genVec`
    (upstream src/Util.hs:114-118);
  * the same generator is trivially portable to numpy (tests/oracle) and C++
    (native runtime) for bit-exact cross-checks.

For production sampling the framework also exposes `jax.random` keys
(threefry) via `fresh_keys`; SFC32 is the parity/replay path.

SFC32 step (Chris Doty-Humphrey's "Small Fast Counting" generator, the
algorithm behind sfc-random-accelerate):

    t       = a + b + counter
    counter = counter + 1
    a       = b ^ (b >> 9)
    b       = c + (c << 3)
    c       = rotl(c, 21) + t
    output  = t
"""

from __future__ import annotations

import os

import jax
import jax.numpy as jnp
import numpy as np

# float conversion: uniform in [0, 1) with 24 bits of mantissa, the standard
# word32 -> Float mapping ((w >> 8) * 2^-24).
_INV_2_24 = np.float32(1.0 / (1 << 24))


def sfc32_next(state: jnp.ndarray):
    """Advance SFC32. `state` is uint32 [..., 4] = (a, b, c, counter).

    Returns (output_u32 [...], new_state [..., 4]).
    """
    a = state[..., 0]
    b = state[..., 1]
    c = state[..., 2]
    counter = state[..., 3]
    t = a + b + counter
    counter = counter + jnp.uint32(1)
    a = b ^ (b >> 9)
    b = c + (c << 3)
    c = ((c << 21) | (c >> 11)) + t
    return t, jnp.stack([a, b, c, counter], axis=-1)


def sfc32_float(state: jnp.ndarray):
    """One uniform f32 draw in [0, 1) per lane. Returns (u, new_state)."""
    bits, state = sfc32_next(state)
    return (bits >> 8).astype(jnp.float32) * _INV_2_24, state


def gen_vec(state: jnp.ndarray):
    """Three uniforms in [-1, 1]^3, drawn in x, y, z order.

    Parity with `genVec` (upstream src/Util.hs:114-118): each
    component is `u * 2 - 1` from an independent sequential draw.
    Returns (vec [..., 3], new_state).
    """
    x, state = sfc32_float(state)
    y, state = sfc32_float(state)
    z, state = sfc32_float(state)
    v = jnp.stack([x, y, z], axis=-1) * 2.0 - 1.0
    return v, state


def gen_seeds(shape, seed: int | None = None) -> jnp.ndarray:
    """Host-side seeding of a fresh per-pixel SFC32 state array.

    The reference fills the seed matrix from MWC system entropy
    (`genSeeds`, upstream src/Util.hs:122-127).  Here we use numpy's
    PCG64 (optionally deterministic via `seed`) to fill all four state words,
    then burn in 12 rounds so the first outputs decorrelate from the raw
    seed words — the conventional SFC32 warm-up.  This is the ONE seeding
    discipline for every fresh SFC32 state array in the framework: the
    stateless sampler's threefry-derived states get the same 12 rounds
    (render/nee.py:render_batch_physical_stateless), uniformity-checked
    in tests/test_rng.py.

    Returns uint32 [*shape, 4] on the default device.
    """
    rng = np.random.default_rng(
        seed if seed is not None else int.from_bytes(os.urandom(8), "little")
    )
    raw = rng.integers(0, 2**32, size=(*tuple(shape), 4), dtype=np.uint32)
    state = jnp.asarray(raw)
    for _ in range(12):
        _, state = sfc32_next(state)
    return state


def reseed(rng_state_shape, accumulator, seed: int | None = None):
    """Replace every pixel's RNG state with a fresh one, keeping the color.

    Parity with `reseed` (upstream src/Util.hs:129-135): SFC32 streams
    slowly converge, so the host swaps in fresh entropy periodically
    (every 2000 samples in the reference, upstream app/Main.hs:236-239).
    """
    import dataclasses

    return dataclasses.replace(
        accumulator, rng=gen_seeds(rng_state_shape, seed=seed)
    )


def fresh_keys(shape, seed: int = 0) -> jnp.ndarray:
    """Idiomatic `jax.random` path: a grid of threefry keys, one per pixel."""
    key = jax.random.key(seed)
    n = int(np.prod(shape))
    return jax.random.split(key, n).reshape(*shape)


# ---------------------------------------------------------------------------
# numpy twin — used by the pure-numpy oracle renderer and the RNG parity tests
# (bit-exact with the JAX implementation above, and with the C++ runtime's
# sfc32 in runtime/native).
# ---------------------------------------------------------------------------


def np_sfc32_next(state: np.ndarray):
    a = state[..., 0]
    b = state[..., 1]
    c = state[..., 2]
    counter = state[..., 3]
    with np.errstate(over="ignore"):
        t = a + b + counter
        counter = counter + np.uint32(1)
        a = b ^ (b >> np.uint32(9))
        b = c + (c << np.uint32(3))
        c = ((c << np.uint32(21)) | (c >> np.uint32(11))) + t
    return t, np.stack([a, b, c, counter], axis=-1)


def np_sfc32_float(state: np.ndarray):
    bits, state = np_sfc32_next(state)
    return ((bits >> np.uint32(8)).astype(np.float32) * _INV_2_24), state


def np_gen_vec(state: np.ndarray):
    x, state = np_sfc32_float(state)
    y, state = np_sfc32_float(state)
    z, state = np_sfc32_float(state)
    return np.stack([x, y, z], axis=-1) * np.float32(2.0) - np.float32(1.0), state
