"""The single configuration dataclass + CLI plumbing.

The reference scatters configuration across a Cabal build flag, a CLI option
and hard-coded constants (SURVEY.md §5: backend CPP flag at
upstream app/Main.hs:58-67, `--variant streams|inline` at
Main.hs:110-132, 800x600 / 15 bounces / reseed-2000 constants at
Util.hs:186-188, Trace.hs:80-81, Main.hs:236-239).  Here everything is one
dataclass, constructible from CLI args, with the reference's values as
defaults.
"""

from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class RenderConfig:
    # Resolution (reference: hard-coded 800x600, Util.hs:186-188).
    width: int = 800
    height: int = 600
    # Algorithm switch — the reference's `--variant streams|inline`
    # (Main.hs:110-132); `wavefront` is the redesigned `streams`;
    # `physical` is the corrected-BRDF + NEE mode (render/nee.py), the
    # non-parity path SURVEY.md §7 commits to exposing behind a flag.
    algorithm: str = "inline"
    # Next-event estimation (physical mode only).
    nee: bool = True
    # Physical-mode sampler: "sfc32" (per-pixel stateful, parity with the
    # reference's RNG threading) or "threefry" (stateless counter-based
    # `jax.random` — replay any sample from (seed, iteration) alone).
    sampler: str = "sfc32"
    # Inline kernel backend: "auto" (the route ops/routes.py picks:
    # the Pallas megakernel on a GPU, XLA elsewhere), "xla", or "pallas".
    kernel: str = "auto"
    # Bounce limit (maxIterations = 15, Trace.hs:80-81).
    bounces: int = 15
    # Reseed the per-pixel RNGs every N samples (Main.hs:236-239).
    reseed_interval: int = 2000
    # Unbiased early termination (the reference's TODO, Trace.hs:338-340).
    russian_roulette: bool = False
    # Deterministic dielectric ray splitting (wavefront variant only):
    # trace BOTH Fresnel branches at every glass hit instead of choosing
    # one stochastically — the feature the reference stubbed
    # (upstream src/Scene/Trace.hs:116-118, 326-328).
    split: bool = False
    # Wavefront queue capacity as a multiple of the pixel count (1.0 = one
    # slot per primary ray; >1 leaves room for ray splitting).
    queue_factor: float = 1.0
    # RNG seed (None = system entropy, like the reference's MWC seeding).
    seed: Optional[int] = None

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)


def add_cli_args(parser: argparse.ArgumentParser) -> None:
    d = RenderConfig()
    parser.add_argument("--width", type=int, default=d.width)
    parser.add_argument("--height", type=int, default=d.height)
    parser.add_argument(
        "--variant",
        choices=["inline", "wavefront", "streams", "physical"],
        default="inline",
        help="rendering algorithm (streams is an alias for wavefront, "
        "matching the reference CLI; physical = corrected BRDFs + NEE)",
    )
    parser.add_argument(
        "--no-nee", dest="nee", action="store_false", default=True,
        help="disable next-event estimation in physical mode",
    )
    parser.add_argument(
        "--sampler", choices=["sfc32", "threefry"], default=d.sampler,
        help="physical-mode RNG: stateful SFC32 (reference parity) or "
        "stateless threefry (replayable from seed+iteration)",
    )
    parser.add_argument(
        "--kernel", choices=["auto", "xla", "pallas"], default=d.kernel,
        help="inline-variant compute backend: auto (Pallas megakernel on "
        "a GPU, XLA elsewhere), or force one",
    )
    parser.add_argument(
        "--split", action="store_true", default=False,
        help="wavefront variant: deterministic dielectric ray splitting "
        "(both Fresnel branches traced; removes glass branch-choice "
        "variance)",
    )
    parser.add_argument(
        "--queue-factor", type=float, default=2.0,
        help="split-queue capacity as a multiple of the pixel count "
        "(children beyond capacity are dropped)",
    )
    parser.add_argument("--bounces", type=int, default=d.bounces)
    parser.add_argument("--spp", type=int, default=64, help="total samples")
    parser.add_argument("--seed", type=int, default=None)
    parser.add_argument(
        "--russian-roulette", action="store_true", default=False
    )
    parser.add_argument("--reseed-interval", type=int, default=d.reseed_interval)


def config_from_args(args: argparse.Namespace) -> RenderConfig:
    algo = "wavefront" if args.variant == "streams" else args.variant
    return RenderConfig(
        width=args.width,
        height=args.height,
        algorithm=algo,
        bounces=args.bounces,
        reseed_interval=args.reseed_interval,
        russian_roulette=args.russian_roulette,
        nee=getattr(args, "nee", True),
        sampler=getattr(args, "sampler", "sfc32"),
        kernel=getattr(args, "kernel", "auto"),
        split=getattr(args, "split", False),
        queue_factor=getattr(args, "queue_factor", 2.0),
        seed=args.seed,
    )
