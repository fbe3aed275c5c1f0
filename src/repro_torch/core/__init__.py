"""Multi-SPIN core of the port.

The analytic layer (``goodput``, ``channel``, ``bandwidth``, ``lambertw``,
``draft_control``, ``schemes``, ``controller``, ``beyond``) is a verbatim
copy of the JAX package's jax-free modules; ``drafting``, ``verification``
and ``draws`` are the torch ports of the sampling steps.  Those three import
torch and are resolved lazily, so the analytic path stays cheap to import.
"""

from . import (  # noqa: F401
    bandwidth,
    channel,
    controller,
    draft_control,
    goodput,
    lambertw,
    schemes,
)

_LAZY = ("drafting", "verification", "draws")


def __getattr__(name):
    if name in _LAZY:
        import importlib
        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(list(globals()) + list(_LAZY))
