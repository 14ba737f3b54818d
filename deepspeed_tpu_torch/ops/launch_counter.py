"""Launch counters of the hand-written kernels' wrappers.

Each kernel module (``ops/attention/decode.py``, ``flash.py``,
``block_sparse.py`` and ``ops/quant/kernels.py``) owns one
:class:`LaunchCounter`, and its wrapper calls :meth:`LaunchCounter.add`
where it launches its kernel.  The capture of a CUDA graph launches
nothing: while :func:`recording` is open, ``add`` notes the launch in
the recording instead of the counter, and every replay of the graph adds
the recording back (:func:`replay`).  So the counters count real device
launches, eager or replayed.  A graph captured outside
:func:`recording` counts its kernels once, at capture, and not at its
replays.
"""

import contextlib

_RECORDINGS = []          # open recordings, innermost last


class LaunchCounter:
    """Launches per kernel name since the last :meth:`reset`, in all and
    by the compute dtype the wrapper names (``counts(dtype)``)."""

    def __init__(self, *names):
        self._counts = dict.fromkeys(names, 0)
        self._by_dtype = {}

    def add(self, name, dtype=None):
        if _RECORDINGS:
            rec = _RECORDINGS[-1]
            rec[(self, name, dtype)] = rec.get((self, name, dtype), 0) + 1
        else:
            self._count(name, dtype, 1)

    def _count(self, name, dtype, n):
        self._counts[name] += n
        if dtype is not None:
            key = (name, dtype)
            self._by_dtype[key] = self._by_dtype.get(key, 0) + n

    def counts(self, dtype=None):
        """``{name: launches}``; with ``dtype``, only the launches whose
        wrapper named that dtype."""
        if dtype is None:
            return dict(self._counts)
        return {name: self._by_dtype.get((name, dtype), 0)
                for name in self._counts}

    def reset(self):
        for name in self._counts:
            self._counts[name] = 0
        self._by_dtype.clear()


@contextlib.contextmanager
def recording():
    """Collect the launches made inside the block as ``{(counter, name,
    dtype): n}`` (the yielded dict) instead of counting them: the kernels
    a graph capture records."""
    rec = {}
    _RECORDINGS.append(rec)
    try:
        yield rec
    finally:
        _RECORDINGS.pop()


def replay(rec):
    """Count the launches of one replay of a graph recorded as ``rec``."""
    for (counter, name, dtype), n in rec.items():
        counter._count(name, dtype, n)
