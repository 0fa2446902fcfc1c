"""Which implementation each estimator family runs on the current platform.

One place decides whether a family runs through a hand-written Pallas
kernel or through the plain JAX/XLA formulation.  Only the parity
(reference-inline) family has kernels, written for the GPU through Pallas'
Triton route: the forward megakernel (ops/pallas_megakernel.py) and the
fused forward + backward kernel (ops/pallas_megakernel_vjp.py).  Every
other family, and every other platform, runs on XLA.

An explicit request for the kernel on a platform without one raises: the
kernel is never run in interpret mode behind a caller's back.
`interpret=True` is for tests only (Pallas' interpreter on the CPU).
"""

from __future__ import annotations

import jax

XLA = "xla"
TRITON = "triton"

# Estimator families with a kept kernel, per platform.
_KERNELS = {
    "gpu": frozenset({"parity", "parity_grad"}),
}
FAMILIES = frozenset({"parity", "parity_grad", "physical", "split"})


def fast_route(family: str, platform: str | None = None) -> str:
    """The fastest route for `family` on `platform` (default: JAX's default
    backend): "triton" where a kernel is kept, "xla" everywhere else."""
    if family not in FAMILIES:
        raise ValueError(f"unknown estimator family {family!r}")
    platform = platform or jax.default_backend()
    return TRITON if family in _KERNELS.get(platform, ()) else XLA


def use_kernel(
    requested: str,
    family: str,
    platform: str | None = None,
    interpret: bool = False,
) -> bool:
    """Resolve a user-facing backend option ("auto", "xla" or "pallas") to
    whether the Pallas kernel runs.  "pallas" on a platform without a
    kernel raises unless `interpret` (tests only) asks for the interpreter.
    """
    if requested == "auto":
        return fast_route(family, platform) == TRITON
    if requested == XLA:
        return False
    if requested != "pallas":
        raise ValueError(f"unknown backend {requested!r}")
    if not interpret and fast_route(family, platform) != TRITON:
        raise ValueError(
            f"no Pallas kernel for the {family!r} family on "
            f"{platform or jax.default_backend()!r}; use 'xla' or 'auto'"
        )
    return True
