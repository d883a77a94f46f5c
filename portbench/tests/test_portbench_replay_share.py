"""The friction.replay_share reader on a synthetic span store: the share of
the friction calls inside chunks whose centre term replayed the graph."""
import pytest

from portbench import harness
from nbody_streams_tpu_torch import telemetry

from .test_portbench_spans import STORE

# three friction calls in chunks and one outside them: the centre term of
# two of the three replayed the graph
REPLAYS = STORE[:8] + [
    ("friction.step", 400, 600, 3, 1),          # 8: eager, no replay
    ("friction.density", 450, 500, 8, 1),       # 9
    ("integrator.chunk", 1000, 1800, -1, 2),    # 10
    ("friction.step", 1100, 1300, 10, 2),       # 11
    ("friction.density", 1110, 1290, 11, 2),    # 12
    ("friction.replay", 1260, 1280, 12, 2),     # 13
    ("friction.step", 1400, 1500, 10, 3),       # 14
    ("friction.density", 1410, 1490, 14, 3),    # 15
    ("friction.replay", 1420, 1480, 15, 3),     # 16
    ("friction.step", 1900, 1950, -1, 4),       # 17: not in a chunk
    ("friction.replay", 1910, 1940, 17, 4),     # 18
]


def test_replay_share_counts_the_calls_in_chunks(monkeypatch):
    from nbody_streams_tpu_torch import friction

    read = harness.reader("friction.replay_share").read
    monkeypatch.setattr(telemetry, "dropped", lambda: 0)
    monkeypatch.setattr(telemetry, "spans", lambda: list(REPLAYS))
    assert read({"steps": 3}) == pytest.approx(2 / 3)
    # no replay at all (the capture raised): 0
    monkeypatch.setattr(telemetry, "spans", lambda: [
        s for s in REPLAYS if s[0] != "friction.replay"])
    assert read({"steps": 3}) == 0.0
    # no friction call in a chunk, no span store, a dropped span, or a
    # program without the graph: nothing to read
    monkeypatch.setattr(telemetry, "spans", lambda: list(STORE[:8]))
    assert read({"steps": 3}) is None
    monkeypatch.setattr(telemetry, "spans", lambda: [])
    assert read({"steps": 3}) is None
    monkeypatch.setattr(telemetry, "spans", lambda: list(REPLAYS))
    monkeypatch.setattr(telemetry, "dropped", lambda: 1)
    assert read({"steps": 3}) is None
    monkeypatch.setattr(telemetry, "dropped", lambda: 0)
    monkeypatch.delattr(friction, "GRAPHS")
    assert read({"steps": 3}) is None
