"""portbench/spans.py's interval arithmetic on a synthetic span store and
gap list, through the metric readers that use it."""
import numpy as np
import pytest

from portbench import harness, spans
from nbody_streams_tpu_torch import telemetry

# (name, start, end, parent, step), ns, in the order they opened
STORE = [
    ("entry.start", 0, 100, -1, None),          # 0
    ("dispatch.gravity", 50, 70, 0, 0),         # 1
    ("field.force", 75, 95, 0, 0),              # 2: not inside a chunk
    ("integrator.chunk", 100, 800, -1, 0),      # 3
    ("dispatch.gravity", 150, 300, 3, 1),       # 4
    ("dispatch.sync", 200, 250, 4, 1),          # 5
    ("field.force", 300, 400, 3, 1),            # 6
    ("field.sync", 320, 340, 6, 1),             # 7
    ("friction.step", 400, 600, 3, 1),          # 8
    ("friction.density", 450, 500, 8, 1),       # 9
    ("friction.sync", 550, 560, 8, 1),          # 10
    ("entry.boundary", 800, 900, -1, 2),        # 11
]
GAPS = np.array([[40, 60], [120, 160], [240, 330], [590, 610], [850, 950],
                 [960, 1000]], float)
# each gap split by the innermost span open:
#   [40, 60]: entry.start 10, dispatch.gravity 10
#   [120, 160]: chunk 30, dispatch.gravity 10
#   [240, 330]: dispatch.sync 10, dispatch.gravity 50, field.force 20,
#               field.sync 10
#   [590, 610]: friction.step 10, chunk 10
#   [850, 950]: entry.boundary 50, no span 50;  [960, 1000]: no span 40
IDLE = {"entry": 60.0, "dispatch": 80.0, "integrator": 40.0, "field": 30.0,
        "friction": 10.0, None: 90.0}
NEW = ["idle_in.entry.iso", "idle_in.integrator.iso", "idle_in.dispatch.iso",
       "step.syncs.iso", "idle_in.entry.field", "idle_in.integrator.field",
       "idle_in.dispatch.field", "idle_in.field_force", "idle_in.friction",
       "step.syncs.field", "field.host_ms", "friction.host_ms"]


@pytest.fixture
def store(monkeypatch):
    monkeypatch.setattr(telemetry, "spans", lambda: list(STORE))
    monkeypatch.setattr(telemetry, "dropped", lambda: 0)


# the profiler's host events: an op (host work) and the runtime's
# synchronise inside field.sync (counted once)
HOST = [("aten::add", 360, 380), ("cudaStreamSynchronize", 325, 335)]


def _rec(host=HOST):
    return {"steps": 2, "trace": {"window_s": 1e-6, "gaps": GAPS,
                                  "host": list(host)}}


def test_innermost_intervals_tile_each_span():
    a, b, idx = spans.own_intervals(STORE)
    assert (a[1:] >= b[:-1]).all()                  # disjoint, in order
    own = {i: 0 for i in range(len(STORE))}
    for x, y, i in zip(a, b, idx):
        own[i] += y - x
    assert own[3] == 700 - 150 - 100 - 200          # the chunk less children
    assert own[4] == 150 - 50 and own[8] == 200 - 50 - 10


def test_idle_split_by_the_innermost_span():
    got = spans.idle_by_layer(STORE, GAPS)
    assert got == pytest.approx(IDLE)
    assert sum(got.values()) == pytest.approx((GAPS[:, 1] - GAPS[:, 0]).sum())
    # gaps in any order, none at all
    assert spans.idle_by_layer(STORE, GAPS[::-1]) == pytest.approx(IDLE)
    assert spans.idle_by_layer(STORE, np.zeros((0, 2))) == {None: 0.0}


def test_readers_on_the_synthetic_store(store):
    rec = _rec()
    got = {m: harness.reader(m).read(rec) for m in NEW}
    share = {k: v * 1e-9 / 1e-6 for k, v in IDLE.items()}
    for suf in ("iso", "field"):
        for lay in ("entry", "integrator", "dispatch"):
            assert got[f"idle_in.{lay}.{suf}"] == pytest.approx(share[lay])
        # dispatch.sync, field.sync and friction.sync are inside the chunk
        assert got[f"step.syncs.{suf}"] == 1.5
    assert got["idle_in.field_force"] == pytest.approx(share["field"])
    assert got["idle_in.friction"] == pytest.approx(share["friction"])
    # the shares sum to the idle that some span covers
    covered = sum(got[m] for m in ("idle_in.entry.field",
                                   "idle_in.integrator.field",
                                   "idle_in.dispatch.field",
                                   "idle_in.field_force", "idle_in.friction"))
    assert covered == pytest.approx((310 - 90) * 1e-3)
    # host ms a step: the chunk's field.force (100 ns) less its field.sync
    # (20 ns), the friction.step (200) less its friction.sync (10) but not
    # its density; the field.force of the call's start is left out
    assert got["field.host_ms"] == pytest.approx(80e-6 / 2)
    assert got["friction.host_ms"] == pytest.approx(190e-6 / 2)


def test_host_ms_leaves_out_the_runtimes_calls(store):
    """A launch that blocks behind a long kernel is a wait, not the
    layer's host work; so is every other call into the CUDA runtime or
    driver, whichever span it falls under."""
    host = HOST + [
        ("cudaLaunchKernel", 345, 395),     # field.force: a full queue
        ("cudaMemcpyAsync", 398, 402),      # 2 in each of the two
        ("cudaLaunchKernel", 410, 412),     # friction.step
        ("cuLaunchKernel", 470, 475),       # under friction.density
        ("cudaLaunchKernel", 160, 170),     # dispatch.gravity: no reader
        ("aten::mul", 420, 440),            # host work
    ]
    rec = _rec(host)
    field = harness.reader("field.host_ms").read(rec)
    friction = harness.reader("friction.host_ms").read(rec)
    assert field == pytest.approx((100 - 20 - 50 - 2) * 1e-6 / 2)
    assert friction == pytest.approx((200 - 2 - 2 - 5 - 10) * 1e-6 / 2)
    # the syncs and the idle shares do not read the host events
    for m in NEW:
        if not m.endswith("host_ms"):
            assert harness.reader(m).read(rec) == pytest.approx(
                harness.reader(m).read(_rec())), m


def test_every_new_reader_returns_none_without_spans(monkeypatch):
    telemetry.clear()
    rec = _rec()
    for m in NEW:
        assert harness.reader(m).read(rec) is None, m
    # a store that dropped spans is not read either
    monkeypatch.setattr(telemetry, "spans", lambda: list(STORE))
    monkeypatch.setattr(telemetry, "dropped", lambda: 1)
    for m in NEW:
        assert harness.reader(m).read(rec) is None, m


def test_idle_readers_need_a_trace(store):
    """The idle shares need the device's gaps, the host ms the profiler's
    host events; the syncs are counted from the store alone."""
    rec = {"steps": 2}
    for m in NEW:
        val = harness.reader(m).read(rec)
        assert (val is None) == (not m.startswith("step.syncs.")), m


def test_a_program_without_spans(monkeypatch):
    """A program without the telemetry module: nothing is read and
    nothing raises."""
    import builtins

    real = builtins.__import__

    def no_telemetry(name, globals=None, locals=None, fromlist=(), level=0):
        if name == "nbody_streams_tpu_torch" and "telemetry" in (fromlist
                                                                 or ()):
            raise ImportError("cannot import name 'telemetry'")
        return real(name, globals, locals, fromlist, level)

    monkeypatch.setattr(builtins, "__import__", no_telemetry)
    for m in NEW:
        assert harness.reader(m).read(_rec()) is None, m
