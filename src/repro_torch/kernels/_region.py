"""The hook through which the kernel wrappers of ``ops.py`` mark their
calls for a step counter.  ``launch/roofline.py`` installs its side
(:func:`install`) when it is imported; until then, and while no counter
is active, a region is a no-op that reckons nothing."""
from __future__ import annotations


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def io(self, *inputs, out=None):
        pass


NULL = _Null()
_hook = None


def install(hook):
    """``hook(name, *args)``: the region context of a kernel call, or
    :data:`NULL` when no counter is active on this thread."""
    global _hook
    _hook = hook


def region(name: str, *args):
    """The context a kernel wrapper runs its call in.  ``args`` (shapes and
    flags) are what the region's FLOPs are reckoned from, by an active
    counter only."""
    return NULL if _hook is None else _hook(name, *args)
