"""What the profiler saw inside the traced window.

The window is the ``record_function`` span the harness puts around its
call; device activity (kernels, copies, fills) is clipped to it.  Times
are the profiler's own (nanoseconds of one clock for host and device).
"""
from __future__ import annotations

import numpy as np

WINDOW = "portbench.window"


def _span(ev):
    start = ev.start_ns() if hasattr(ev, "start_ns") else ev.start_us() * 1e3
    dur = (ev.duration_ns() if hasattr(ev, "duration_ns")
           else ev.duration_us() * 1e3)
    return float(start), float(start + dur)


def _on_device(ev):
    return str(ev.device_type()).rsplit(".", 1)[-1] == "CUDA"


def _kind(ev):
    kind = getattr(ev, "activity_type", None)
    return str(kind()).lower() if callable(kind) else ""


def _is_kernel(ev):
    kind = getattr(ev, "activity_type", None)
    if callable(kind):
        return "kernel" in str(kind()).lower()
    name = ev.name().lower()
    return not ("memcpy" in name or "memset" in name)


def read(prof) -> dict:
    """``window_s``, ``busy_s`` (the union of device intervals), the
    kernels as (name, seconds), the host's events that overlap the window
    and the idle gaps (an (n, 2) array, ns), from a finished
    ``torch.profiler.profile``."""
    events = prof.profiler.kineto_results.events()
    windows = [_span(e) for e in events
               if not _on_device(e) and e.name() == WINDOW]
    if not windows:
        raise RuntimeError(f"the trace holds no {WINDOW!r} span")
    w0, w1 = windows[0]
    dev, kernels, host = [], [], []
    for e in events:
        if e.name() == WINDOW or "annotation" in _kind(e):
            continue   # the window's own span, on the host and the device
        a, b = _span(e)
        if _on_device(e):
            a, b = max(a, w0), min(b, w1)
            if b <= a:
                continue
            dev.append((a, b))
            if _is_kernel(e):
                kernels.append((e.name(), (b - a) * 1e-9))
        elif b > w0 and a < w1:
            host.append((e.name(), a, b))
    busy, gaps = _union(sorted(dev), w0, w1)
    return {"window_s": (w1 - w0) * 1e-9, "busy_s": busy * 1e-9,
            "kernels": kernels, "gaps": gaps, "host": host}


def _union(intervals, w0, w1):
    """(busy ns, idle gaps as an (n, 2) array) of sorted intervals."""
    busy, gaps, end = 0.0, [], w0
    for a, b in intervals:
        if a > end:
            gaps.append((end, a))
        if b > end:
            busy += b - max(a, end)
            end = b
    if w1 > end:
        gaps.append((end, w1))
    return busy, np.asarray(gaps, float).reshape(-1, 2)


def breakdown(t, top=10, longest=100) -> dict:
    """The device operations that took most time, and the ``longest``
    idle gaps summed by the host event that overlaps each most (what the
    host was doing while the device waited), ``top`` of each."""
    ops: dict[str, float] = {}
    for name, s in t["kernels"]:
        ops[name] = ops.get(name, 0.0) + s
    gaps = t["gaps"]
    idle: dict[str, float] = {}
    if len(gaps):
        pick = gaps[np.argsort(gaps[:, 0] - gaps[:, 1])[:longest]]
        names = [h[0] for h in t["host"]]
        hs = np.array([h[1] for h in t["host"]] or [0.0])
        he = np.array([h[2] for h in t["host"]] or [0.0])
        for g0, g1 in pick:
            over = np.minimum(he, g1) - np.maximum(hs, g0)
            k = int(np.argmax(over))
            label = names[k] if names and over[k] > 0 else "no host event"
            idle[label] = idle.get(label, 0.0) + (g1 - g0) * 1e-9
    def best(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])
                ][:top]
    return {"device_ops": best(ops), "idle_gaps": best(idle)}
