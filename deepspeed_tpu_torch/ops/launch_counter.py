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
    """Launches per kernel name since the last :meth:`reset`."""

    def __init__(self, *names):
        self._counts = dict.fromkeys(names, 0)

    def add(self, name):
        if _RECORDINGS:
            rec = _RECORDINGS[-1]
            rec[(self, name)] = rec.get((self, name), 0) + 1
        else:
            self._counts[name] += 1

    def counts(self):
        return dict(self._counts)

    def reset(self):
        for name in self._counts:
            self._counts[name] = 0


@contextlib.contextmanager
def recording():
    """Collect the launches made inside the block as ``{(counter, name):
    n}`` (the yielded dict) instead of counting them: the kernels a graph
    capture records."""
    rec = {}
    _RECORDINGS.append(rec)
    try:
        yield rec
    finally:
        _RECORDINGS.pop()


def replay(rec):
    """Count the launches of one replay of a graph recorded as ``rec``."""
    for (counter, name), n in rec.items():
        counter._counts[name] += n
