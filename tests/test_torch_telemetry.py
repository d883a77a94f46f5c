"""The port's spans (telemetry.py) in a small satellite run on the CPU.

A 256-particle satellite in an NFW host with friction (centre every 5
steps) runs 12 KDK steps on the sorted path (its threshold lowered to the
run's N) with a restart every 6 steps: without a profiler it records no
span; under ``torch.profiler`` it records every span of the step path,
nested as the layers call each other, one ``dispatch.gravity`` and,
inside it, one ``dispatch.sort`` and one ``dispatch.sync`` an evaluation,
one ``friction.centre`` a refresh, and
none of them in the profiler's own events.  Under
``telemetry.annotating()`` (how ``run_nbody(profile_dir=)`` holds its
profiler) each span is a ``record_function`` in the profiler's trace too,
and the stored times follow the profiler's events for them.  A run's phase
space is the same bit for bit with the profiler on and off.
"""
import contextlib
import json

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import nbody_streams_tpu_torch as tst
from nbody_streams_tpu_torch import telemetry
from nbody_streams_tpu_torch.ops import cuda_direct as cd
from nbody_streams_tpu_torch.potentials import NFWPotential

N, STEPS, DT, EVERY = 256, 12, 2e-3, 5
# a stored time against the profiler's event for the same span (the
# profiler's entry and exit take up to ~30 us each on a loaded CPU); 95% of
# the spans are held to it, and the median to MEDIAN_NS (2-4 us seen), which
# an offset between the two clocks would break
ALIGN_NS = 50_000
MEDIAN_NS = 10_000


@pytest.fixture
def satellite(monkeypatch, tmp_path):
    """run() -> the final phase space of the run, on the sorted path."""
    monkeypatch.setattr(cd, "SORT_MIN_N", 128)
    host = NFWPotential(mass=1e12, scaleRadius=20.0)
    xv, m = tst.make_plummer_sphere(N, M_total=1e8, a=0.3, seed=4)
    xv = tst.place_on_orbit(xv, r_peri=28.0, r_apo=32.0, potential=host)
    sp = [tst.Species.dark(N=N, mass=float(m[0]), softening=0.05)]
    calls = []

    def run(**kw):
        calls.append(len(calls))
        out = tst.run_simulation(
            xv, sp, 0.0, STEPS * DT, DT, architecture="cpu", impl="cuda",
            external_potential=host, dynamical_friction=True,
            df_M_sat=5e10, df_update_interval=EVERY, restart_interval=6,
            output_dir=str(tmp_path / str(calls[-1])),
            save_snapshots=False, verbose=False, **kw)
        return out["dark"]

    return run


def _traced(run, annotate=False):
    telemetry.clear()
    with profile(activities=[ProfilerActivity.CPU]) as prof, (
            telemetry.annotating() if annotate else contextlib.nullcontext()):
        out = run()
    return out, telemetry.spans(), prof


def _span_events(prof, names):
    return sorted((e for e in prof.profiler.kineto_results.events()
                   if e.name() in names), key=lambda e: e.start_ns())


def _chain(spans, i):
    """Names of span ``i``'s ancestors, innermost first."""
    out = []
    while spans[i][3] >= 0:
        i = spans[i][3]
        out.append(spans[i][0])
    return out


def test_no_span_without_a_profiler(satellite):
    telemetry.clear()
    satellite()
    assert telemetry.spans() == [] and telemetry.dropped() == 0
    assert telemetry.span("dispatch.gravity") is telemetry.span("x.y")
    assert not isinstance(telemetry.span("x.y"), telemetry._Span)


def test_spans_of_a_traced_run(satellite):
    before = dict(cd.BRANCHES)
    _, spans, _ = _traced(satellite)
    sorted_calls = sum(cd.BRANCHES[b] - before[b]
                       for b in ("two_pass", "single_pass"))
    names = [s[0] for s in spans]
    count = {k: names.count(k) for k in set(names)}
    evaluations = STEPS + 1
    assert count == {
        "entry.start": 2,              # run_simulation's and run_nbody's
        "integrator.chunk": 2,         # to steps 6 and 12
        "entry.boundary": 3,           # steps 6 and 12, the final fetch
        "dispatch.sort": evaluations,  # each sorted call sorts its input
        "dispatch.gravity": evaluations,
        "dispatch.sync": evaluations,
        "field.force": evaluations,
        "friction.step": evaluations,
        "friction.centre": len(range(0, STEPS + 1, EVERY)),
        "friction.density": evaluations,
    }
    assert sorted_calls == evaluations
    assert all(s[2] is not None and s[1] <= s[2] for s in spans)
    for i, (name, start, end, parent, step) in enumerate(spans):
        chain = _chain(spans, i)
        if name in ("friction.density", "friction.centre"):
            assert chain[0] == "friction.step"
        if name in ("dispatch.sort", "dispatch.sync"):
            assert chain[0] == "dispatch.gravity"
        if name.startswith(("dispatch.", "field.", "friction.")):
            # the first evaluation is the call's start, the rest chunks'
            first = step == 0
            assert chain[-1] == ("entry.start" if first
                                 else "integrator.chunk"), (name, step)
        if parent >= 0:
            assert spans[parent][1] <= start and end <= spans[parent][2]
        if name in ("dispatch.sort", "dispatch.sync", "friction.centre",
                    "friction.density"):
            assert step == spans[parent][4]      # inherited
    # every step of the run evaluates once, each under its own step number
    steps = [s[4] for s in spans if s[0] == "dispatch.gravity"]
    assert steps == list(range(evaluations))
    centres = [s[4] for s in spans if s[0] == "friction.centre"]
    assert centres == list(range(0, STEPS + 1, EVERY))


def test_dispatch_sync_one_a_sorted_call():
    """``_self_sorted`` at a small geometry: one ``dispatch.sync`` inside
    each call, whichever branch it takes, after the ``dispatch.sort`` of
    the call's own slab order."""
    g = torch.Generator().manual_seed(3)
    pos = torch.randn(300, 3, generator=g)
    gm = torch.full((300,), 1e-3)
    soft = torch.full((300,), 0.05)
    telemetry.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        for mode in ("acc", "pot"):
            cd._self_sorted(pos, gm, soft, "spline", True, mode, 1e-12,
                            tm=64, tn=64)
    assert [s[0] for s in telemetry.spans()] == ["dispatch.sort",
                                                 "dispatch.sync"] * 2


def test_spans_stay_out_of_another_profilers_events(satellite):
    _, spans, prof = _traced(satellite)
    assert spans and not _span_events(prof, {s[0] for s in spans})


def test_stored_times_follow_the_profilers_events(satellite):
    _traced(satellite, annotate=True)   # warm every path and the profiler
    _, spans, prof = _traced(satellite, annotate=True)
    events = _span_events(prof, {s[0] for s in spans})
    assert [e.name() for e in events] == [s[0] for s in spans]
    late = np.asarray([(s[1] - e.start_ns(),
                        s[2] - e.start_ns() - e.duration_ns())
                       for s, e in zip(spans, events)])
    # the same clock: no offset between the two; a preempted host thread
    # can push the odd span out
    assert np.mean(np.abs(late) < ALIGN_NS, 0).min() >= 0.95, late
    assert np.median(np.abs(late), 0).max() < MEDIAN_NS, late


def test_phase_space_bitwise_with_and_without_a_profiler(satellite):
    plain = satellite()
    traced, spans, _ = _traced(satellite)
    annotated, _, _ = _traced(satellite, annotate=True)
    assert spans
    np.testing.assert_array_equal(plain, traced)
    np.testing.assert_array_equal(plain, annotated)


def test_profile_dir_trace_holds_the_spans(satellite, tmp_path):
    telemetry.clear()
    satellite(profile_dir=str(tmp_path / "prof"))
    trace, = (tmp_path / "prof").glob("nbody_trace_*.json")
    names = {e.get("name") for e in json.loads(trace.read_text())[
        "traceEvents"]}
    # the profiler holds the chunks: the call's start lies before it
    assert {"integrator.chunk", "dispatch.gravity", "dispatch.sync",
            "field.force", "friction.step", "friction.centre",
            "friction.density", "entry.boundary"} <= names
    assert telemetry.spans()


def test_the_store_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(telemetry, "CAP", 3)
    telemetry.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        with telemetry.span("a.outer", step=7):
            for _ in range(4):
                with telemetry.span("b.inner"):
                    pass
    spans = telemetry.spans()
    assert [s[0] for s in spans] == ["a.outer", "b.inner", "b.inner"]
    assert [s[3] for s in spans] == [-1, 0, 0]
    assert [s[4] for s in spans] == [7, 7, 7]
    assert telemetry.dropped() == 2
    telemetry.clear()
    assert telemetry.spans() == [] and telemetry.dropped() == 0
