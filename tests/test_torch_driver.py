"""Port parity, the PPR driver: ``repro_torch.launch.ppr_run`` against
``repro.launch.ppr_run``.

Both ``main``s run in-process at the reference's defaults (``--scale 0.02``,
pl_1e5 cut to |V| = 2,000), the port with ``--device cpu``.  Their standard
output is compared line by line with the timing fields masked: the accuracy
block against the float64 oracle exactly in Q1.25 (fixed point is bit-exact)
and within 1e-5 in ``--float``; ``--serve``'s count lines; every
``--replay-deltas`` round line and telemetry line.  The flags whose slice is
not ported yet raise ``NotImplementedError`` naming it, before any graph is
built.
"""
import re
import sys

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

import repro.launch.ppr_run as rrun  # noqa: E402
import repro_torch.graphs  # noqa: E402
import repro_torch.launch.ppr_run as trun  # noqa: E402

_TIMES = [
    (re.compile(r"in \d+\.\d+s \(\d+\.\d+ req/s"), "in <s>s (<r> req/s"),
    (re.compile(r"apply \d+\.\d+ ms"), "apply <ms> ms"),
    (re.compile(r"q in \d+\.\d+s"), "q in <s>s"),
]


def _reference(monkeypatch, capsys, argv):
    monkeypatch.setattr(sys, "argv", ["ppr_run"] + argv)
    rrun.main()
    return capsys.readouterr().out


def _port(capsys, argv):
    trun.main(argv + ["--device", "cpu"])
    return capsys.readouterr().out


def _masked(out):
    """Output lines with the timing fields masked; telemetry lines that are
    timings (latencies, rates) dropped."""
    lines = []
    for line in out.splitlines():
        if re.match(r"\s+\S*(latency|_per_s)\S*\s", line):
            continue
        for pat, sub in _TIMES:
            line = pat.sub(sub, line)
        lines.append(line)
    return lines


def _accuracy(lines):
    """{metric: value} of the accuracy block, and the lines before it."""
    at = next(i for i, ln in enumerate(lines) if ln.startswith("accuracy vs CPU oracle"))
    block = {}
    for ln in lines[at + 1:]:
        key, value = ln.split()
        block[key] = float(value)
    assert len(block) == 7
    return block, lines[:at + 1]


@pytest.mark.parametrize("argv,tol", [([], 0.0), (["--float"], 1e-5),
                                      (["--bits", "20", "--kappa", "16",
                                        "--requests", "40"], 0.0)],
                         ids=["Q1.25", "float", "Q1.19-k16"])
def test_default_mode_accuracy_matches_reference(monkeypatch, capsys, argv, tol):
    want, want_head = _accuracy(_masked(_reference(monkeypatch, capsys, argv)))
    got, got_head = _accuracy(_masked(_port(capsys, argv)))
    assert got_head == want_head
    assert got.keys() == want.keys()
    for key in want:
        assert abs(got[key] - want[key]) <= tol, (key, got[key], want[key])


@pytest.mark.parametrize("argv", [["--serve"], ["--serve", "--float", "--topk", "5"]],
                         ids=["Q1.25", "float"])
def test_serve_mode_count_lines_match_reference(monkeypatch, capsys, argv):
    want = _masked(_reference(monkeypatch, capsys, argv))
    got = _masked(_port(capsys, argv))
    assert got == want
    assert any("queries_served" in ln for ln in got)


@pytest.mark.parametrize("argv", [["--replay-deltas", "3"],
                                  ["--replay-deltas", "2", "--float",
                                   "--delta-edges", "16"]],
                         ids=["Q1.25", "float"])
def test_replay_deltas_lines_match_reference(monkeypatch, capsys, argv):
    want = _masked(_reference(monkeypatch, capsys, argv))
    got = _masked(_port(capsys, argv))
    assert got == want
    rounds = [ln for ln in got if ln.lstrip().startswith("round ")]
    assert len(rounds) == int(argv[1])
    assert "prefetch_issued" in "\n".join(got)


@pytest.mark.parametrize("argv,slice_name", [
    (["--http", "0"], "HTTP"),
    (["--serve", "--shards", "4"], "multi-GPU"),
    (["--serve", "--trace"], "observability"),
    (["--serve", "--dump-traces", "3"], "observability"),
    (["--serve", "--trace-sample", "0.5"], "observability"),
    (["--http", "0", "--slo"], "HTTP"),
    (["--slo"], "observability"),
    (["--otlp-endpoint", "http://localhost:4318"], "observability"),
], ids=["http", "shards", "trace", "dump-traces", "trace-sample", "http-slo", "slo",
        "otlp"])
def test_unported_flags_raise_before_any_graph(monkeypatch, argv, slice_name):
    def no_graph(*a, **kw):
        raise AssertionError("a graph was built before the flag was refused")

    monkeypatch.setattr(repro_torch.graphs, "paper_graph_suite", no_graph)
    with pytest.raises(NotImplementedError, match=slice_name):
        trun.main(argv + ["--device", "cpu"])


def test_default_device_is_cuda_and_raises_without_a_gpu(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card; the check is for hosts without one")

    def no_graph(*a, **kw):
        raise AssertionError("a graph was built before the device was resolved")

    monkeypatch.setattr(repro_torch.graphs, "paper_graph_suite", no_graph)
    with pytest.raises(RuntimeError, match="cuda"):
        trun.main(["--scale", "0.01"])
