"""BENCHMARK.json's rules and the result line's contract, with injected
timings and trace readings."""

import json
import math
import re
import statistics

import pytest
import torch

from gpad_bench import harness, trace

SPEC = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
RUN = harness.load_module(harness.BENCH / "run.py", "gpad_bench_run")


def test_top_level_keys_and_limits():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["gpad_bench"]
    assert SPEC["command"][1].startswith("gpad_bench/")
    rs = SPEC["run_seconds"]
    assert 1 <= rs <= 51
    # a full check of 24 cells fits its 43200 seconds
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_entries():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in SPEC[group]:
            assert NAME.match(e["name"]) and e["name"] not in seen
            seen.add(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
            for key in ("why", "layer", "source"):
                if key in e:
                    assert 1 <= len(e[key]) <= 200
                    assert "\n" not in e[key] and "\t" not in e[key]
    for e in SPEC["end_to_end"]:
        assert set(e) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert e["source"] in ("host_clock", "device_trace")
        assert 0.01 <= e["bound"] <= 0.25
    for e in SPEC["per_layer"]:
        assert set(e) <= {"name", "unit", "better", "source", "layer", "moves",
                          "workloads"}
        assert e["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert e["workloads"], e["name"]
        if "roofline" in e["name"]:
            assert "_roofline" in e["name"] and e["unit"] == "%"


def test_every_cell_reports_enough():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    configs = {c["name"] for c in SPEC["configs"]}
    pairs = set()
    for w in SPEC["workloads"]:
        assert w["chips"] in (1, 4) and w["config"] in configs
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cell = harness.load_cell(w["name"])
        names = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in names and len(names) >= 2 and cell.per_layer
    for m in SPEC["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", []):
            assert m["moves"] in {x["name"] for x in harness.load_cell(w).end_to_end}
    assert {c for w in SPEC["workloads"] for c in [w["config"]]} == configs


def _run(trace_on=False):
    cell = harness.load_cell("battery_n3_N10.fleet")
    r = harness.Run(cell, 7, 10.0, trace_on, torch.device("cpu"), 100.0)
    r.window_start = 112.5
    r.attempted = 6000
    r.e2e["solves_per_s"] = 9.5e6
    r.memory_peak_bytes = 123
    r.readings = {"dualize_s": 0.25, "host_s_per_call": [3e-4, 5e-4, 4e-4],
                  "bound_s_per_unit": 1.7e-4,
                  "trace": {"busy_s": 0.9, "window_s": 1.0, "units": 500,
                            "device_ops": [["k", 0.8]], "idle_gaps": [["h", 0.1]]}}
    r.check("z_gap", 1e-6)
    return r


def test_untraced_line():
    line = RUN.result_line(_run(), False, "NVIDIA H100 80GB HBM3")
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True and line["attempted"] == 6000
    assert line["metrics"] == {
        "solves_per_s": {"value": 9.5e6, "unit": "solves/s"},
        "setup_s": {"value": 12.5, "unit": "s"}}
    assert line["device"] == {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3",
                              "count": 1, "memory_peak_bytes": 123}
    limit = harness.load_cell("battery_n3_N10.fleet").limits["z_gap"]
    assert line["checks"] == {"z_gap": {"value": 1e-6, "limit": limit}}
    json.dumps(line)


def test_traced_line_reads_the_per_layer_metrics():
    line = RUN.result_line(_run(True), True, "card")
    m = {k: v["value"] for k, v in line["metrics"].items()}
    assert m["host_ms_per_call.fleet"] == pytest.approx(0.4)
    # 0.17 ms of bound over 0.9 s / 500 calls of busy device
    assert m["solve_roofline_pct.fleet"] == pytest.approx(100 * 1.7e-4 / 1.8e-3)
    assert m["device_idle_pct.fleet"] == pytest.approx(10.0)
    assert m["dualize_s"] == 0.25
    assert line["device"]["busy_s"] == 0.9 and line["device"]["window_s"] == 1.0
    assert line["breakdown"] == {"device_ops": [["k", 0.8]], "idle_gaps": [["h", 0.1]]}
    assert list(line)[-1] == "checks"


def test_a_reader_that_finds_nothing_leaves_its_metric_out():
    r = _run(True)
    r.readings = {"dualize_s": 0.25, "host_s_per_call": [], "trace": None}
    assert set(harness.per_layer_values(r)) == {"dualize_s"}
    for m in SPEC["per_layer"]:
        reader = harness.load_module(harness.BENCH / "metrics" / f"{m['name']}.py")
        assert reader.read({}) is None


def test_a_gap_over_its_limit_or_nan_is_not_correct():
    r = _run()
    r.check("z_gap", 1.5 * r.cell.limits["z_gap"])
    assert not r.correct
    r.check("z_gap", math.nan)
    assert not r.correct


def test_trace_reduction_busy_union_and_gaps():
    span = {"ph": "X", "cat": "user_annotation", "name": trace.WINDOW_SPAN,
            "ts": 1000.0, "dur": 1000.0}
    ev = [span,
          {"ph": "X", "cat": "kernel", "name": "a", "ts": 900.0, "dur": 200.0},
          {"ph": "X", "cat": "kernel", "name": "b", "ts": 1050.0, "dur": 100.0},
          {"ph": "X", "cat": "gpu_memcpy", "name": "c", "ts": 1500.0, "dur": 100.0},
          {"ph": "X", "cat": "cpu_op", "name": "aten::mm", "ts": 1200.0, "dur": 250.0},
          {"ph": "X", "cat": "cpu_op", "name": "outer", "ts": 1150.0, "dur": 800.0}]
    out = trace.reduce(ev)
    assert out["window_s"] == pytest.approx(1e-3)
    assert out["busy_s"] == pytest.approx(2.5e-4)  # [1000,1150) + [1500,1600)
    gaps = dict(out["idle_gaps"])
    assert gaps["aten::mm"] == pytest.approx(3.5e-4)  # 1150-1500, mid 1325
    assert gaps["outer"] == pytest.approx(4e-4)  # 1600-2000, mid 1800
    assert dict(out["device_ops"])["a"] == pytest.approx(1e-4)


def test_host_ms_reader_is_the_median():
    reader = harness.load_module(harness.BENCH / "metrics" / "host_ms_per_call.fleet.py")
    assert reader.read({"host_s_per_call": [1e-3, 5e-3, 2e-3]}) == pytest.approx(
        1e3 * statistics.median([1e-3, 5e-3, 2e-3]))


def test_trace_reduction_between_markers():
    """The device-only window runs from its first device operation (the
    opening marker) to its last (the closing one)."""
    ev = [{"ph": "X", "cat": "kernel", "name": "mark", "ts": 100.0, "dur": 2.0},
          {"ph": "X", "cat": "kernel", "name": "k", "ts": 150.0, "dur": 50.0},
          {"ph": "X", "cat": "kernel", "name": "k", "ts": 180.0, "dur": 40.0},
          {"ph": "X", "cat": "kernel", "name": "mark", "ts": 298.0, "dur": 2.0}]
    out = trace.reduce(ev, span=False)
    assert out["window_s"] == pytest.approx(200e-6)
    assert out["busy_s"] == pytest.approx(74e-6)
    assert dict(out["device_ops"])["k"] == pytest.approx(90e-6)
