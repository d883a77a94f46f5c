"""Spans at the layer boundaries of a run, recorded while a torch profiler
records.

``span(name, step=None)`` is a context manager.  While no profiler records
(``torch._C._autograd._profiler_enabled()`` is false) it hands back one
shared no-op context: the flag check is the whole cost.  While one records
it appends ``(name, start_ns, end_ns, parent, step)`` to an in-memory
store: times from ``time.time_ns()``, the clock of the profiler's own time
stamps; ``parent`` the index of the enclosing span in the store (-1 for
none); ``step`` the caller's, or else the parent's.

Inside ``annotating()`` (``run_nbody(profile_dir=)`` holds its profiler
so) a span also opens ``torch.profiler.record_function(name)``, so that it
shows in the Chrome trace: its start is then the midpoint of a read just
before and one just after the profiler's entry, which takes its own stamp
in between (on a loaded CPU either side can take tens of microseconds),
its end a read just after the profiler's exit, which stamps at its last.
Under any other profiler the spans go to the store alone: the profiler
lays a ``record_function`` on the device's timeline too, as a range over
the kernels launched inside it, and a reader of that profiler's device
events (a benchmark's idle time, say) would count it as device work.

The spans of a step, by layer (the prefix of a name, up to its first
dot):

* ``entry.start`` (``run_simulation``'s and ``run_nbody``'s start up to
  the first chunk, the first force evaluation inside), ``entry.boundary``
  (a boundary's fetch, NaN check, snapshot and restart; the final fetch);
* ``integrator.chunk`` (one ``run_chunk``), ``integrator.sync`` (the
  watchdog's synchronise after a chunk);
* ``dispatch.sort`` (the slab order, taken in the KDK step from its
  drifted positions just before the force), ``dispatch.gravity`` (one
  ``solver.accel`` or ``solver.potential`` call), ``dispatch.sync`` (the
  sorted path's branch read, ``cuda_direct._self_sorted``);
* ``field.force`` (the external field's ``force`` on its refresh steps);
* ``friction.step`` (the extra force's call), ``friction.centre`` (the
  friction's centre on its refresh steps), ``friction.density`` (its
  density, dispersion and acceleration at the centre), inside it
  ``friction.replay`` (one replay of the CUDA graph that the friction
  captures of those on the card).

A span named ``<layer>.sync`` holds one call that blocks the host on the
device.  The store keeps at most ``CAP`` spans and counts those it drops
(``dropped()``); ``clear()`` empties it.  It belongs to the process and to
the thread that runs the integration.
"""
from __future__ import annotations

import contextlib
import time

import torch

__all__ = ["span", "spans", "clear", "dropped", "CAP"]

#: the most spans the store keeps (about 100 MB of tuples at most)
CAP = 1_000_000

_profiling = torch._C._autograd._profiler_enabled
_NOOP = contextlib.nullcontext()
_store: list = []       # [name, start_ns, end_ns, parent, step] lists
_open: list = []        # store indices of the spans open now
_dropped = 0
_annotate = 0           # > 0 inside annotating()


class _Span:
    __slots__ = ("name", "step", "rf", "index")

    def __init__(self, name, step):
        self.name, self.step = name, step

    def __enter__(self):
        global _dropped
        parent = _open[-1] if _open else -1
        step = self.step
        if step is None and parent >= 0:
            step = _store[parent][4]
        if len(_store) < CAP:
            self.index = len(_store)
            _store.append([self.name, None, None, parent, step])
        else:
            self.index = -1
            _dropped += 1
        _open.append(self.index)
        if _annotate:
            self.rf = torch.profiler.record_function(self.name)
            before = time.time_ns()
            self.rf.__enter__()
            start = (before + time.time_ns()) // 2
        else:
            self.rf = None
            start = time.time_ns()
        if self.index >= 0:
            _store[self.index][1] = start
        return self

    def __exit__(self, *exc):
        if self.rf is not None:
            self.rf.__exit__(*exc)
        _open.pop()
        if self.index >= 0:
            _store[self.index][2] = time.time_ns()
        return False


def span(name: str, step: int | None = None):
    """A span named ``name`` (``<layer>.<what>``) around a ``with`` block,
    recorded only while a torch profiler records."""
    if not _profiling():
        return _NOOP
    return _Span(name, step)


@contextlib.contextmanager
def annotating():
    """Inside, a recorded span also opens a ``record_function`` (see the
    module)."""
    global _annotate
    _annotate += 1
    try:
        yield
    finally:
        _annotate -= 1


def spans() -> list[tuple]:
    """The recorded spans as ``(name, start_ns, end_ns, parent, step)``
    tuples in the order they opened (``end_ns`` None while open)."""
    return [tuple(s) for s in _store]


def dropped() -> int:
    """Spans not kept since the last ``clear()`` (the store was full)."""
    return _dropped


def clear() -> None:
    """Empty the store and its count of dropped spans."""
    global _dropped
    _store.clear()
    _open.clear()
    _dropped = 0
