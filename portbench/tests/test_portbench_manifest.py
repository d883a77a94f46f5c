"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""
import json
import re

import pytest

from portbench import harness

MAN = harness.manifest()
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}")


def test_keys_and_command():
    assert set(MAN) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert MAN["paths"] == ["portbench"]
    assert all(not w.startswith("/") and ".." not in w
               for w in MAN["command"])
    assert 1 <= MAN["run_seconds"] <= 51
    cells = len(MAN["workloads"])
    # the driver's whole check at 24 cells fits its 43,200 s
    assert (2 + 14 * 24) * (MAN["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert 1 <= cells <= 24


def test_names_units_and_bounds():
    names = [e["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in MAN[k]]
    assert len(names) == len(set(names))
    assert all(NAME.fullmatch(n) for n in names)
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.fullmatch(m["unit"]) and m["better"] in ("lower",
                                                            "higher")
    for m in MAN["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert {m["name"] for m in MAN["end_to_end"]} >= {"setup_s"}


@pytest.mark.parametrize("w", MAN["workloads"], ids=lambda w: w["name"])
def test_each_cell_finds_its_files_and_metrics(w):
    cfg, mod = harness.config(w["config"])
    assert all(hasattr(mod, f) for f in ("make_inputs", "sim_kwargs",
                                        "program_field", "reference_terms"))
    assert harness.traffic(w["traffic"])["n_body"] > 0
    assert harness.cell_file(w["name"])["steps_per_second"] > 0
    assert set(cfg["limits"]) == {"acc_err", "pos_err"}
    e2e = harness.metrics_for(MAN, w["name"], trace=False)
    layer = harness.metrics_for(MAN, w["name"], trace=True)
    assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2
    assert layer
    for m in e2e + layer:
        assert callable(harness.reader(m["name"]).read)
    for m in layer:
        assert m["moves"] in {e["name"] for e in e2e}
        assert getattr(harness.reader(m["name"]), "MOVES",
                       m["moves"]) == m["moves"]


def test_configs_hold_their_reduced_keys():
    for c in MAN["configs"]:
        cfg = json.loads((harness.ROOT / c["file"]).read_text())
        assert cfg["reduced"] == c["reduced"]
        assert all(k in cfg for k in c["reduced"])
        assert cfg["source"] == c["source"]


def test_metrics_for_without_a_workloads_key():
    man = {"end_to_end": [{"name": "a"}, {"name": "b", "workloads": ["x"]}],
           "per_layer": [{"name": "p", "moves": "a"},
                         {"name": "q", "moves": "b"},
                         {"name": "r", "moves": "b", "workloads": ["y"]}]}
    assert [m["name"] for m in harness.metrics_for(man, "y", False)] == ["a"]
    assert [m["name"] for m in harness.metrics_for(man, "y", True)] == [
        "p", "r"]
    assert [m["name"] for m in harness.metrics_for(man, "x", True)] == [
        "p", "q"]
