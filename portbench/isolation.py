"""What a run may not load: JAX, its libraries, or the JAX package that
the program was ported from. Names are compared by their top-level part
(before the first dot), whole: `cometbft_tpu_torch` is not
`cometbft_tpu`."""
from __future__ import annotations

import sys
from typing import Iterable, List, Optional

FORBIDDEN = ("jax", "jaxlib", "flax", "cometbft_tpu")


class IsolationError(RuntimeError):
    pass


def top_level(names: Iterable[str]) -> set:
    return {n.split(".", 1)[0] for n in names}


def loaded_forbidden(names: Optional[Iterable[str]] = None) -> List[str]:
    """The forbidden top-level names among `names` (default: the modules
    this process has loaded)."""
    names = list(sys.modules) if names is None else names
    return sorted(top_level(names) & set(FORBIDDEN))
