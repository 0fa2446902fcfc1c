"""ctypes bindings to the native runtime (runtime/native/ptru_native.cpp).

API mirrors the Python implementations it accelerates / cross-checks:

  * `sfc32_advance` / `sfc32_uniforms` — bit-exact with `ops/rng.py`
    (JAX) and its numpy twin; used by the RNG parity tests.
  * `tonemap_rgb8` / `write_png` — the output fast path used by
    `utils/image.py` when available (the reference needed the same native
    escape hatch for its display conversion,
    upstream app/Main.hs:378-381).
  * `render_inline` — the scalar C++ oracle of the reference's Inline
    algorithm; an independent implementation the JAX renderer is checked
    against (tests/test_native.py).
  * `trace_physical_nee` — the scalar C++ oracle of the physical/NEE
    estimator (round 5): the THIRD independent implementation of the
    NEE family next to render/nee.py and parity/oracle_nee_np.py.

`available()` is the capability gate: if g++ or zlib are missing the
framework silently uses the pure-Python paths.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from . import build

_lib: Optional[ctypes.CDLL] = None
_load_error: Optional[str] = None

_u32p = np.ctypeslib.ndpointer(np.uint32, flags="C_CONTIGUOUS")
_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _load_error
    if _lib is not None or _load_error is not None:
        return _lib
    try:
        lib = ctypes.CDLL(build.library_path())
    except (build.BuildError, OSError) as e:
        _load_error = str(e)
        return None

    lib.ptru_sfc32_advance.argtypes = [_u32p, ctypes.c_int64, ctypes.c_int]
    lib.ptru_sfc32_uniforms.argtypes = [
        _u32p, _f32p, ctypes.c_int64, ctypes.c_int,
    ]
    lib.ptru_tonemap_rgb8.argtypes = [
        _f32p, _u8p, ctypes.c_int64, ctypes.c_float, ctypes.c_float,
    ]
    lib.ptru_write_png.argtypes = [
        ctypes.c_char_p, _u8p, ctypes.c_int, ctypes.c_int,
    ]
    lib.ptru_write_png.restype = ctypes.c_int
    lib.ptru_trace_physical_nee.argtypes = [
        _f32p, _f32p,                          # spheres pos/rad
        _f32p, _f32p,                          # planes pos/nor
        _f32p, _f32p, _f32p,                   # tris v0/v1/v2
        _f32p, _f32p, _i32p, _f32p,            # materials (s++p++t)
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        _f32p, _f32p, _u32p, _f32p,            # rays o/d, rng, radiance
        ctypes.c_int64, ctypes.c_int,
    ]
    lib.ptru_render_inline.argtypes = [
        _f32p, _f32p, ctypes.c_int,            # spheres
        _f32p, _f32p, ctypes.c_int,            # planes
        _f32p, _f32p, _i32p, _f32p,            # materials
        _f32p, _f32p, ctypes.c_float,          # camera
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,  # w,h,b,spp
        _f32p, _u32p, ctypes.c_int,            # color, rng, threads
    ]
    _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


def load_error() -> Optional[str]:
    _load()
    return _load_error


def sfc32_advance(state: np.ndarray, rounds: int = 1) -> np.ndarray:
    """Advance SFC32 states in place; state [..., 4] u32. Returns state."""
    lib = _load()
    assert lib is not None
    flat = np.ascontiguousarray(state.reshape(-1, 4), np.uint32)
    lib.ptru_sfc32_advance(flat, flat.shape[0], rounds)
    return flat.reshape(state.shape)


def sfc32_uniforms(state: np.ndarray, draws: int = 1):
    """Draw uniforms per lane. Returns (out [..., draws] f32, new state)."""
    lib = _load()
    assert lib is not None
    flat = np.ascontiguousarray(state.reshape(-1, 4), np.uint32)
    out = np.empty((flat.shape[0], draws), np.float32)
    lib.ptru_sfc32_uniforms(flat, out, flat.shape[0], draws)
    return out.reshape(*state.shape[:-1], draws), flat.reshape(state.shape)


def tonemap_rgb8(
    image: np.ndarray, exposure: float = 1.0, gamma: float = 2.2
) -> np.ndarray:
    """Native tonemap: HDR [..., 3] f32 -> LDR [..., 3] u8."""
    lib = _load()
    assert lib is not None
    flat = np.ascontiguousarray(image, np.float32)
    out = np.empty(flat.shape, np.uint8)
    lib.ptru_tonemap_rgb8(
        flat.reshape(-1, 3), out.reshape(-1, 3), flat.size // 3,
        exposure, 1.0 / gamma,
    )
    return out


def write_png(path: str, rgb8: np.ndarray) -> None:
    lib = _load()
    assert lib is not None
    h, w, c = rgb8.shape
    assert c == 3 and rgb8.dtype == np.uint8
    rc = lib.ptru_write_png(
        path.encode(), np.ascontiguousarray(rgb8), w, h
    )
    if rc != 0:
        raise OSError(f"ptru_write_png failed with code {rc} for {path!r}")


def render_inline(
    scene,
    camera,
    color: np.ndarray,
    rng_state: np.ndarray,
    num_bounces: int = 15,
    spp: int = 1,
    n_threads: int = 0,
):
    """C++ oracle render: returns (color + spp samples of radiance, rng').

    Accepts the framework's Scene/Camera pytrees; arrays are copied to
    contiguous host buffers.  Semantics: `render Inline`
    (upstream src/Scene/Trace.hs:193-200) — see ptru_native.cpp.
    """
    lib = _load()
    assert lib is not None
    sp, pl = scene.spheres, scene.planes
    F = np.float32
    c32 = lambda a: np.ascontiguousarray(np.asarray(a, F))
    mat_cat = lambda f: np.concatenate(
        [np.asarray(getattr(sp.material, f)), np.asarray(getattr(pl.material, f))]
    )
    color_out = np.ascontiguousarray(np.asarray(color, F)).copy()
    rng_out = np.ascontiguousarray(np.asarray(rng_state, np.uint32)).copy()
    h, w = color_out.shape[:2]
    lib.ptru_render_inline(
        c32(sp.pos), c32(sp.radius), sp.pos.shape[0],
        c32(pl.pos), c32(pl.normal), pl.pos.shape[0],
        c32(mat_cat("color")), c32(mat_cat("illuminance")),
        np.ascontiguousarray(mat_cat("brdf_kind"), np.int32),
        c32(mat_cat("brdf_param")),
        c32(camera.position), c32(camera.rotation),
        float(np.asarray(camera.fov)),
        w, h, num_bounces, spp,
        color_out, rng_out, n_threads,
    )
    return color_out, rng_out


def trace_physical_nee(scene, ray_o, ray_d, rng_state, bounces: int):
    """Scalar C++ oracle of `render/nee.py:trace_physical(nee=True)`
    under the shade-frame convention (spheres + planes + triangles).  `ray_o`/`ray_d` are [..., 3] f32, `rng_state` [..., 4]
    u32.  Returns (radiance [..., 3] f32, rng_out [..., 4] u32)."""
    lib = _load()
    assert lib is not None, _load_error
    assert scene.boxes.count == 0, "NEE oracle covers spheres+planes+tris"
    shape = np.asarray(ray_o).shape[:-1]
    n = int(np.prod(shape))
    f = lambda a: np.ascontiguousarray(np.asarray(a, np.float32))
    ns, npl, nt = scene.spheres.count, scene.planes.count, \
        scene.triangles.count
    cat = lambda field: np.concatenate([
        np.asarray(getattr(scene.spheres.material, field)),
        np.asarray(getattr(scene.planes.material, field)),
        np.asarray(getattr(scene.triangles.material, field)),
    ])
    color = f(cat("color").reshape(-1, 3))
    illum = f(cat("illuminance").reshape(-1))
    kind = np.ascontiguousarray(cat("brdf_kind").astype(np.int32))
    param = f(cat("brdf_param").reshape(-1))
    rng = np.ascontiguousarray(
        np.asarray(rng_state, np.uint32).reshape(n, 4)
    ).copy()
    rad = np.zeros((n, 3), np.float32)
    one3 = np.zeros((1, 3), np.float32)
    lib.ptru_trace_physical_nee(
        f(scene.spheres.pos.reshape(-1, 3)),
        f(np.asarray(scene.spheres.radius).reshape(-1)),
        f(scene.planes.pos.reshape(-1, 3)) if npl else one3,
        f(scene.planes.normal.reshape(-1, 3)) if npl else one3,
        f(scene.triangles.v0.reshape(-1, 3)) if nt else one3,
        f(scene.triangles.v1.reshape(-1, 3)) if nt else one3,
        f(scene.triangles.v2.reshape(-1, 3)) if nt else one3,
        color, illum, kind, param, ns, npl, nt,
        f(np.asarray(ray_o).reshape(n, 3)),
        f(np.asarray(ray_d).reshape(n, 3)),
        rng, rad, n, bounces,
    )
    return rad.reshape(*shape, 3), rng.reshape(*shape, 4)
