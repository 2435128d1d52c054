"""The modules that no process of the benchmark may hold: JAX and the JAX
package beside the port, compared by whole top-level names (the port's
name, slacken_tpu_torch, begins with slacken_tpu)."""

from __future__ import annotations

import sys
from typing import Iterable, List

FORBIDDEN = frozenset({"jax", "jaxlib", "flax", "slacken_tpu", "bench", "scale_bench"})


class Forbidden(RuntimeError):
    def __init__(self, names: List[str]):
        super().__init__("the process holds forbidden modules: " + ", ".join(names))
        self.names = names


def top_level(names: Iterable[str]) -> set:
    return {n.split(".")[0] for n in names}


def loaded() -> List[str]:
    """The forbidden top-level names that sys.modules holds."""
    return sorted(top_level(list(sys.modules)) & FORBIDDEN)
