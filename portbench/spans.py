"""What the program's own spans say about the traced window.

The program (``nbody_streams_tpu_torch.telemetry``) records a span at each
layer boundary of its step path while a profiler records: in a run, the
harness's traced window and nothing else, each run being its own process.
A span is ``(name, start_ns, end_ns, parent, step)`` on the profiler's
clock; its layer is its name up to the first dot, and ``<layer>.sync``
holds one host read that waits for the device.  The host waits on the
device in the CUDA runtime's calls too (a kernel launch blocks while
CUDA's launch queue is full behind a long kernel): ``host_ms`` leaves
those out, read from the profiler's host events (``trace.read``'s
``host``).

An idle instant of the device (``trace.read``'s ``gaps``) is put down to
the innermost span open on the host at that instant.  A reader returns
None where the program has no span store (a program older than it), the
store is empty, or it dropped spans.
"""
from __future__ import annotations

import re

import numpy as np

SYNC = ".sync"
CHUNK = "integrator.chunk"
#: the CUDA runtime's and driver's calls among the profiler's host events
RUNTIME = re.compile(r"cu(da)?[A-Z]")


def store():
    """The program's spans of the window, or None (see the module)."""
    try:
        from nbody_streams_tpu_torch import telemetry
    except ImportError:
        return None
    spans = telemetry.spans()
    if not spans or telemetry.dropped():
        return None
    return spans


def own_intervals(spans):
    """(starts, ends, span indices) of the disjoint intervals in which each
    span is the innermost one open: its own interval less its children's,
    in time order."""
    children = [[] for _ in spans]
    for i, s in enumerate(spans):
        if s[3] >= 0:
            children[s[3]].append(i)
    segs = []
    for i, (_, start, end, _, _) in enumerate(spans):
        cur = start
        for c in children[i]:
            c0, c1 = spans[c][1], spans[c][2]
            if c0 > cur:
                segs.append((cur, c0, i))
            cur = max(cur, c1)
        if end > cur:
            segs.append((cur, end, i))
    segs.sort()
    a = np.asarray(segs, float).reshape(-1, 3)
    return a[:, 0], a[:, 1], a[:, 2].astype(int)


def _idle_before(gaps, t):
    """Idle ns before each time in ``t``: the sorted, disjoint ``gaps``
    ((n, 2), ns) summed up to it (any such intervals' measure so)."""
    g0, g1 = gaps[:, 0], gaps[:, 1]
    cum = np.concatenate([[0.0], np.cumsum(g1 - g0)])
    k = np.searchsorted(g0, t, side="right") - 1
    inside = np.clip(t - g0[np.maximum(k, 0)], 0.0,
                     (g1 - g0)[np.maximum(k, 0)])
    return np.where(k >= 0, cum[np.maximum(k, 0)] + inside, 0.0)


def idle_by_layer(spans, gaps):
    """Idle ns under each layer's spans (each instant under the innermost
    span open), and under no span at the key None."""
    gaps = np.asarray(gaps, float).reshape(-1, 2)
    gaps = gaps[np.argsort(gaps[:, 0])]
    total = float((gaps[:, 1] - gaps[:, 0]).sum())
    out = {None: total}
    if not len(gaps):
        return out
    a, b, idx = own_intervals(spans)
    idle = _idle_before(gaps, b) - _idle_before(gaps, a)
    for i, ns in zip(idx, idle):
        key = spans[i][0].split(".", 1)[0]
        out[key] = out.get(key, 0.0) + ns
        out[None] -= ns
    return out


def idle_share(rec, name):
    """The traced window's idle time under layer ``name``'s spans over the
    window; None without a trace or a span store."""
    t, spans = rec.get("trace"), store()
    if not t or spans is None or t["window_s"] <= 0:
        return None
    return float(idle_by_layer(spans, t["gaps"]).get(name, 0.0)) * 1e-9 \
        / t["window_s"]


def _in_chunk(spans, i):
    while spans[i][3] >= 0:
        i = spans[i][3]
        if spans[i][0] == CHUNK:
            return True
    return False


def syncs_per_step(rec):
    """``*.sync`` spans inside ``integrator.chunk`` spans over the window's
    steps."""
    spans = store()
    if spans is None:
        return None
    n = sum(1 for i, s in enumerate(spans)
            if s[0].endswith(SYNC) and _in_chunk(spans, i))
    return n / rec["steps"]


def _merge(intervals):
    """The sorted, disjoint union of (start, end) pairs, as (n, 2)."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return np.asarray(out, float).reshape(-1, 2)


def host_ms(rec, name):
    """The time of the ``name`` spans inside chunks less the host's waits
    on the device in them, in ms over the window's steps; None without the
    profiler's host events or where no such span was recorded.

    A wait is a ``*.sync`` span or a call into the CUDA runtime or driver
    (a host event named ``cuda*`` or ``cu*``): a launch blocks there while
    CUDA's launch queue is full behind a long kernel.  The runtime's calls
    are left out whole, a normal launch's few microseconds with them."""
    t, spans = rec.get("trace"), store()
    if not t or spans is None:
        return None
    inside = [s for i, s in enumerate(spans)
              if s[0] == name and _in_chunk(spans, i)]
    if not inside:
        return None
    waits = _merge([(s[1], s[2]) for s in spans if s[0].endswith(SYNC)]
                   + [(a, b) for n, a, b in t.get("host", ())
                      if RUNTIME.match(n)])
    a = np.asarray([s[1] for s in inside], float)
    b = np.asarray([s[2] for s in inside], float)
    own = (b - a).sum()
    if len(waits):
        own -= (_idle_before(waits, b) - _idle_before(waits, a)).sum()
    return float(own) * 1e-6 / rec["steps"]
