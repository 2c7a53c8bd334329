"""The check that the JAX package and JAX never load in the run's process.
Names are compared whole, by the part before the first dot: the port's
package name begins with the JAX package's."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = ("jax", "jaxlib", "flax", "nnstreamer_tpu")


def loaded(forbidden: Iterable[str] = FORBIDDEN, modules: Iterable[str] = None) -> List[str]:
    names = sys.modules if modules is None else modules
    bad = set(forbidden)
    return sorted({m.split(".", 1)[0] for m in names if m.split(".", 1)[0] in bad})
