"""A run's last line, through the harness at the CPU's sizes, and the
consistency of BENCHMARK.json with the files it names."""
import json
import re
import subprocess
import sys

import pytest

from portbench import harness

BENCH = json.loads((harness.ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("workload", CELLS)
def test_last_line_keys_and_check_last(workload, tiny_cell):
    cell = tiny_cell(workload)
    result = harness.run_cell(cell, 2**31 + 3, 0.4, False, device="cpu")
    keys = list(result)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks"
    assert result["correct"] is True, result["checks"]
    assert result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(m["value"] > 0 for m in result["metrics"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(result["device"])
    for c in result["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.dumps(result, allow_nan=False)


def test_every_named_file_and_reader_exists():
    for c in BENCH["configs"]:
        assert (harness.ROOT / c["file"]).is_file()
    for w in BENCH["workloads"]:
        tr = json.loads((harness.HERE / "traffic" / f"{w['traffic']}.json").read_text())
        assert (harness.HERE / "checks" / f"{tr['check']}.json").is_file()
        assert w["chips"] == 1
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert callable(harness.load_reader(m["name"]))


def test_names_and_metric_wiring_follow_the_contract():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    names = [x["name"] for x in BENCH["configs"] + BENCH["workloads"]
             + BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for cell in CELLS:
        reported = [n for n, m in e2e.items() if cell in m.get("workloads", [cell])]
        assert "setup_s" in reported and len(reported) >= 2
        assert any(cell in m["workloads"] for m in BENCH["per_layer"])
    for m in BENCH["per_layer"]:
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])


def test_run_without_a_card_exits_nonzero_and_prints_no_result(cpu_only):
    out = subprocess.run([sys.executable, str(harness.HERE / "run.py"), "--workload",
                          CELLS[0], "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120,
                         cwd=harness.ROOT)
    assert out.returncode != 0
    assert "{" not in out.stdout
