"""The metric readers on synthetic records and event lists."""
import math
from types import SimpleNamespace

import numpy as np
import pytest

from portbench import harness, peaks, trace


def test_roofline_count_at_the_bench_case():
    assert math.isclose(peaks.pair_seconds(), 19 / 67e12)
    assert math.isclose(peaks.evaluation_seconds(65536) * 1e3, 1.218,
                        rel_tol=1e-3)
    assert math.isclose(peaks.evaluation_seconds(1048576), 0.3118,
                        rel_tol=1e-3)


class _Ev:
    """A stand-in for the profiler's kineto event."""

    def __init__(self, name, start_ns, dur_ns, device, kind="kernel"):
        self._n, self._s, self._d, self._dev, self._k = (
            name, start_ns, dur_ns, device, kind)

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def device_type(self):
        return f"DeviceType.{self._dev}"

    def activity_type(self):
        return self._k


def _prof(events):
    results = SimpleNamespace(events=lambda: events)
    return SimpleNamespace(profiler=SimpleNamespace(kineto_results=results))


EVENTS = [
    _Ev(trace.WINDOW, 1000, 10_000, "CPU", "user_annotation"),
    _Ev(trace.WINDOW, 1000, 10_000, "CUDA", "gpu_user_annotation"),
    _Ev("aten::item", 3000, 3000, "CPU", "cpu_op"),
    _Ev("void direct_tile_kernel<4>", 500, 1500, "CUDA"),     # clipped
    _Ev("band_kernel", 2500, 1200, "CUDA"),
    _Ev("elementwise", 3000, 1000, "CUDA"),                   # overlaps
    _Ev("Memcpy DtoH", 8000, 500, "CUDA", "gpu_memcpy"),
    _Ev("combine_kernel", 12000, 500, "CUDA"),                # outside
]


def test_idle_share_of_known_intervals():
    t = trace.read(_prof(EVENTS))
    # busy: [1000, 2000) + [2500, 4000) + [8000, 8500) = 3000 of 10000 ns
    assert t["window_s"] == pytest.approx(1e-5)
    assert t["busy_s"] == pytest.approx(3e-6)
    rec = {"trace": t, "n": 8, "steps": 2, "evaluations": 3,
           "branches": {"two_pass": 1, "single_pass": 3}}
    assert harness.reader("device.idle_share.iso").read(rec) == \
        pytest.approx(0.7)
    # the gaps: [2000, 2500), [4000, 8000) (the host in aten::item for
    # [3000, 6000) overlaps it), [8500, 11000)
    assert np.allclose(t["gaps"], [[2000, 2500], [4000, 8000],
                                   [8500, 11000]])
    assert len(t["kernels"]) == 3
    assert harness.reader("step.launches.field").read(rec) == 1.5
    assert harness.reader("gravity.single_pass_share.iso").read(rec) == 0.75
    b = trace.breakdown(t)
    assert b["device_ops"][0][0] == "band_kernel"
    assert b["idle_gaps"] == [["aten::item", pytest.approx(4e-6)],
                              ["no host event", pytest.approx(3e-6)]]


def test_roofline_and_mfu_readers():
    t = {"window_s": 2.0, "busy_s": 1.0, "gaps": np.zeros((0, 2)),
         "host": [],
         "kernels": [("void direct_tile_kernel<4, 0>", 0.004),
                     ("band_kernel", 0.001), ("elementwise_kernel", 0.3)]}
    rec = {"trace": t, "n": 65536, "steps": 3, "evaluations": 4,
           "branches": {"two_pass": 4, "single_pass": 0}}
    share = harness.reader("gravity_roofline.iso").read(rec)
    assert share == pytest.approx(100 * 4 * 1.217976e-3 / 0.005, rel=1e-5)
    mfu = harness.reader("step_mfu.field").read(rec)
    assert mfu == pytest.approx(100 * 4 * 65536.0 ** 2 * 19 / (67e12 * 2))
    assert harness.reader("gravity.single_pass_share.iso").read(rec) == 0


def test_readers_return_nothing_without_a_trace():
    rec = {"n": 10, "steps": 20, "evaluations": 21, "window_s": 1.0,
           "setup_s": 3.0, "branches": {"two_pass": 0, "single_pass": 0}}
    for name in ("device.idle_share.iso", "gravity_roofline.field",
                 "step_mfu.iso", "step.launches.iso",
                 "gravity.single_pass_share.field"):
        assert harness.reader(name).read(rec) is None
    assert harness.reader("step_ms").read(rec) == 50.0
    assert harness.reader("setup_s").read(rec) == 3.0


def test_steps_for_a_window():
    # one more than a multiple of 10: the friction refreshes at K - 1
    assert harness.steps_for(30.0, 320) == 9601
    assert harness.steps_for(30.0, 1.4) == 41
    assert harness.steps_for(30.0, 1.5) == 51
    assert harness.steps_for(5.0, 2.0) == 21
