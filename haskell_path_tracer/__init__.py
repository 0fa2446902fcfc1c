"""haskell_path_tracer — a differentiable path tracer in JAX.

A from-scratch JAX / XLA / Pallas reimagining of the capabilities of
`robbert-vdh/haskell-path-tracer` (surveyed in SURVEY.md): a
progressive Monte-Carlo path tracer with

  * an inline megakernel integrator (fused `lax.fori_loop` bounce loop) and
    a wavefront integrator (fixed-capacity ray queues with stream
    per-lane split stacks) — the reference's `Inline` / `Streams` algorithm pair;
  * per-pixel SFC32 RNG threading with periodic reseeding;
  * progressive accumulation with camera-motion invalidation;
  * differentiable rendering (gradients w.r.t. material / emission /
    geometry parameters) for inverse rendering;
  * SPMD sharding of image tiles and sample batches over a device mesh.
"""

from .models.objects import (
    Accumulator,
    Boxes,
    Camera,
    Materials,
    Planes,
    Rays,
    Scene,
    Spheres,
    Triangles,
    BRDF_MATTE,
    BRDF_GLOSSY,
    BRDF_DIELECTRIC,
    make_boxes,
    make_materials,
    make_planes,
    make_spheres,
    make_triangles,
)
from .models.world import initial_camera, main_scene
from .models.io import load_scene, save_scene
from .models.camera import primary_rays
from .render.integrator import (
    make_accumulator,
    render_batch_inline,
    render_sample_inline,
    trace_inline,
)
from .render.wavefront import (
    WavefrontStats,
    depth_histogram,
    render_batch_wavefront,
    render_batch_wavefront_split,
    render_sample_wavefront,
    render_sample_wavefront_split,
)
from .render.nee import render_batch_physical, render_sample_physical
from .render.renderer import Renderer
from .utils.config import RenderConfig

__version__ = "0.2.0"
