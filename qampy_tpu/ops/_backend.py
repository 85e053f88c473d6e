"""The one place that maps the platform a program runs on to its kernels.

Every op asks :func:`use_kernel` whether to run a hand-written kernel or
XLA's plain version. The family of hand-written kernels per platform:

* ``"gpu"`` -> ``"triton"``: the block-LMS trainer
  (ops/trainer_triton.py, Pallas through Triton). Everything else is XLA.
* ``"cpu"`` and any other platform -> ``"xla"``: no hand-written kernel.

Nothing here selects the Pallas interpreter: interpret mode happens only
where a caller passes ``interpret=True`` to a kernel, as its tests do.
"""
from __future__ import annotations

import jax

#: hand-written kernel family per JAX platform name
FAMILIES = {"gpu": "triton"}


def platform():
    """JAX platform of the default device (``"gpu"``, ``"cpu"``, ...)."""
    return jax.devices()[0].platform


def family(platform_name=None):
    """Kernel family of a platform (default: the running one)."""
    return FAMILIES.get(platform_name or platform(), "xla")


def use_kernel(pallas, reasons=(), what="chain", platform_name=None):
    """Resolve a caller's ``pallas`` request against the platform.

    ``pallas=None`` takes the platform's kernel when the configuration is
    eligible (``reasons`` empty) and XLA otherwise; ``pallas=False`` always
    takes XLA. ``pallas=True`` raises ``ValueError`` when the platform has
    no kernel or the configuration is ineligible: an explicit request never
    falls back.
    """
    fam = family(platform_name)
    if pallas is None:
        return fam != "xla" and not reasons
    if not pallas:
        return False
    if fam == "xla":
        raise ValueError(
            "pallas=True requested for the %s, but platform %r has no "
            "hand-written kernel" % (what, platform_name or platform()))
    if reasons:
        raise ValueError("pallas=True requested for the %s, but the %s "
                         "kernel cannot take it: %s"
                         % (what, fam, "; ".join(reasons)))
    return True


def exact_trainer_default(platform_name=None):
    """``backend="auto"`` of the granular equaliser: the exact sequential
    scan on the CPU (bit-comparable with the reference and fast there),
    the block-LMS trainer on an accelerator."""
    return (platform_name or platform()) == "cpu"
