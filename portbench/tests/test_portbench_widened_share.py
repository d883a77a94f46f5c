"""The gravity.widened_share.field reader on synthetic branch counters: the
share of the sorted path's evaluations that ran a widened band."""
import pytest

from portbench import harness


def test_widened_share_counts_the_widened_calls():
    read = harness.reader("gravity.widened_share.field").read
    # every call widened, as on the stream cell
    assert read({"branches": {"two_pass": 22, "single_pass": 0,
                              "widened": 22}}) == 1.0
    # some calls fit the static band, one fell back to the single pass
    assert read({"branches": {"two_pass": 3, "single_pass": 1,
                              "widened": 1}}) == pytest.approx(0.25)
    # no call widened
    assert read({"branches": {"two_pass": 22, "single_pass": 0,
                              "widened": 0}}) == 0.0


def test_widened_share_is_none_without_the_counter_or_calls():
    read = harness.reader("gravity.widened_share.field").read
    # a program without the counter: nothing to read
    assert read({"branches": {"two_pass": 0, "single_pass": 22,
                              "window_rows": 4719, "band_rows": 2816}}) is None
    # no sorted evaluation in the window
    assert read({"branches": {"two_pass": 0, "single_pass": 0,
                              "widened": 0}}) is None
    assert read({"branches": {}}) is None
