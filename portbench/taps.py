"""What the benchmark attaches to the program, by the names under which
the program calls it.

Every tap is put in place by :class:`Patches` and taken away by its
``close``.  A name the program no longer has is skipped: what reads the
tap then finds nothing and says so (a per-layer metric is left out of the
result line), and the program runs as it is.
"""

from __future__ import annotations

import functools
from typing import Any, Callable, List, Tuple


class Patches:
    """Attributes replaced on modules or objects, put back by
    :meth:`close` (an attribute set on an instance is deleted, so the
    class's method shows again)."""

    def __init__(self):
        self._undo: List[Tuple[Any, str, Any, bool]] = []

    def wrap(self, owner, name: str, make: Callable[[Callable], Callable]
             ) -> bool:
        fn = getattr(owner, name, None)
        if fn is None:
            return False
        own = name in getattr(owner, "__dict__", {})
        setattr(owner, name, make(fn))
        self._undo.append((owner, name, fn, own))
        return True

    def close(self) -> None:
        while self._undo:
            owner, name, fn, own = self._undo.pop()
            if own:
                setattr(owner, name, fn)
            else:
                delattr(owner, name)


def ranged(label: str) -> Callable[[Callable], Callable]:
    """A wrapper that runs the function inside a profiler range."""
    from torch.profiler import record_function

    def make(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with record_function(label):
                return fn(*args, **kwargs)
        return inner
    return make
