"""The run's last check: nothing of JAX and nothing of the JAX package was
loaded. Names are compared whole by their top-level part (before the
first dot), because the port's own name, pcr_tpu_torch, begins with the
JAX package's."""

from __future__ import annotations

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "pcr_tpu", "pcr"})


def forbidden(module_names) -> list:
    """The loaded modules whose top-level name is forbidden, sorted."""
    return sorted(m for m in module_names
                  if m.split(".", 1)[0] in FORBIDDEN)
