"""Library configuration and version — the port's own copy of
``sparse_solvers_tpu/utils/config.py`` (the JAX package imports jax on
import, so the port cannot read it from there). A test holds the two
equal.
"""

from __future__ import annotations

LIB_NAME = "sparse-solvers-tpu"

VERSION_MAJOR = 0
VERSION_MINOR = 2
VERSION_PATCH = 0


def version() -> list[int]:
    """Return ``[major, minor, patch]``, as the reference Python binding's
    ``version()`` does (reference: bindings/python/sparsesolvers/
    binding.cpp:42-45,117)."""
    return [VERSION_MAJOR, VERSION_MINOR, VERSION_PATCH]
