"""Arithmetic the metric readers share.  A reader gets the run's record
(``harness.run``) and returns a number, or None where the run holds
nothing to read."""
from __future__ import annotations

import re

from portbench import peaks


def idle_share(rec):
    """1 - (union of device activity) / the traced window."""
    t = rec.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return 1.0 - t["busy_s"] / t["window_s"]


def kernel_seconds(rec, patterns):
    """Device seconds of the traced kernels whose names match any of
    ``patterns``; None without a trace or without such a kernel."""
    t = rec.get("trace")
    if not t:
        return None
    rx = re.compile("|".join(patterns))
    hits = [s for name, s in t["kernels"] if rx.search(name)]
    return sum(hits) if hits else None


def roofline_pct(rec, patterns):
    """The least time of the window's force evaluations (n^2 pairs each,
    ``peaks``) over the device time of the kernels named by
    ``patterns``, in %."""
    busy = kernel_seconds(rec, patterns)
    if not busy:
        return None
    return 100.0 * rec["evaluations"] * peaks.evaluation_seconds(
        rec["n"]) / busy


def step_mfu_pct(rec):
    """The window's force evaluations' FP32 operations over the card's
    FP32 peak times the traced window, in %."""
    t = rec.get("trace")
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * rec["evaluations"] * peaks.evaluation_flops(rec["n"]) \
        / (peaks.PEAK_FP32 * t["window_s"])


def single_pass_share(rec):
    """Single-pass evaluations over all of the sorted path's, in the
    window (the program's ``cuda_direct.BRANCHES``)."""
    b = rec["branches"]
    total = b.get("single_pass", 0) + b.get("two_pass", 0)
    return b["single_pass"] / total if total else None


def launches_per_step(rec):
    t = rec.get("trace")
    if not t or not t["kernels"]:
        return None
    return len(t["kernels"]) / rec["steps"]
