"""Port parity, the PPR driver: ``repro_torch.launch.ppr_run`` against
``repro.launch.ppr_run``.

Both ``main``s run in-process at the reference's defaults (``--scale 0.02``,
pl_1e5 cut to |V| = 2,000), the port with ``--device cpu``.  Their standard
output is compared line by line with the timing fields masked: the accuracy
block against the float64 oracle exactly in Q1.25 (fixed point is bit-exact)
and within 1e-5 in ``--float``; ``--serve``'s count lines; every
``--replay-deltas`` round line and telemetry line; the flight recorder's
dump under ``--dump-traces`` (``--trace``, ``--trace-sample``), span
durations, event times and latencies masked.  ``--http`` runs as a
subprocess of each package on 127.0.0.1, with ``--slo`` and
``--otlp-endpoint`` pointed at a stdlib collector: the banners, the answers
and the closing ``otlp:`` line agree.  ``--serve --shards N`` on a CPU
mesh prints what the reference's single-device ``--serve`` prints, with the
layout words mapped (the reference's own ``--shards N>1`` fails on this
JAX in its top-K).
"""
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from pathlib import Path

import numpy as np
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
    (re.compile(r" +\d+\.\d+ ms"), " <ms> ms"),
    (re.compile(r"t=\d+\.\d+s "), "t=<s>s "),
    (re.compile(r"latency_s=[^,\]]+"), "latency_s=<s>"),
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


@pytest.mark.parametrize("argv", [
    ["--serve", "--trace", "--dump-traces", "3"],
    ["--serve", "--trace-sample", "0.5", "--dump-traces", "4"],
    ["--serve", "--float", "--trace-sample", "0.25", "--dump-traces", "2"],
    ["--serve", "--trace"],
    ["--replay-deltas", "2", "--dump-traces", "3"],
], ids=["serve-dump", "sample-0.5", "float-sample-0.25", "trace-no-dump",
        "replay-dump"])
def test_trace_flags_print_what_the_reference_prints(monkeypatch, capsys, argv):
    want = _masked(_reference(monkeypatch, capsys, argv))
    got = _masked(_port(capsys, argv))
    assert got == want
    if "--dump-traces" in argv:
        n = int(argv[argv.index("--dump-traces") + 1])
        assert sum(ln.startswith("  trace ") for ln in got) == n
        assert any(ln.startswith("flight recorder: ") for ln in got)


class _Collector:
    """A stdlib OTLP/HTTP collector on 127.0.0.1: counts the spans and
    metric payloads POSTed to it."""

    def __init__(self):
        self.spans, self.metric_posts = 0, 0
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_POST(self):
                body = json.loads(self.rfile.read(int(self.headers["Content-Length"])))
                if self.path.endswith("/v1/traces"):
                    outer.spans += sum(len(ss["spans"])
                                       for rs in body["resourceSpans"]
                                       for ss in rs["scopeSpans"])
                else:
                    outer.metric_posts += 1
                self.send_response(200)
                self.send_header("Content-Length", "0")
                self.end_headers()

            def log_message(self, *args):
                pass

        self.server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()
        self.url = f"http://127.0.0.1:{self.server.server_address[1]}"

    def close(self):
        self.server.shutdown()
        self.server.server_close()


def _http_run(module, extra):
    """``ppr_run --http 0`` as a subprocess: read the banner, POST four
    queries and GET /v1/slo, then SIGINT.  Returns the answers, the SLO
    status code, the collector's span count and the process's stdout."""
    import asyncio

    from repro_torch.ppr_serving.http import http_request

    col = _Collector()
    src = Path(__file__).resolve().parents[1] / "src"
    cmd = [sys.executable, "-m", module, "--http", "0", "--scale", "0.01",
           "--bits", "20", "--trace", "--slo", "--otlp-endpoint", col.url] + extra
    env = dict(os.environ, PYTHONPATH=str(src), JAX_PLATFORMS="cpu")
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env)
    try:
        head = []
        deadline = time.time() + 120
        while time.time() < deadline:
            line = proc.stdout.readline()
            assert line, proc.stderr.read()
            head.append(line.rstrip("\n"))
            if "GET  /v1/debug/traces" in line:
                break
        port = int(re.search(r"http://127\.0\.0\.1:(\d+)", "\n".join(head)).group(1))

        async def traffic():
            out = []
            for v, p in ((3, 20), (5, None), (3, 20), (7, "auto")):
                status, _, body = await http_request(
                    "127.0.0.1", port, "POST", "/v1/ppr",
                    {"graph": "pl_1e5", "vertex": v, "k": 5, "precision": p})
                out.append((status, body))
            slo_status, _, _ = await http_request("127.0.0.1", port, "GET", "/v1/slo")
            return out, slo_status

        answers, slo_status = asyncio.run(traffic())
        proc.send_signal(signal.SIGINT)
        proc.wait(timeout=120)
        # the same buffered reader as the banner: it may hold lines already
        rest, err = proc.stdout.read(), proc.stderr.read()
        return (answers, slo_status, col.spans, proc.returncode,
                head + rest.splitlines(), err)
    finally:
        if proc.poll() is None:
            proc.kill()
        with proc:                        # closes the pipes, reaps the process
            pass
        col.close()


def test_http_mode_serves_like_the_reference():
    want = _http_run("repro.launch.ppr_run", [])
    got = _http_run("repro_torch.launch.ppr_run", ["--device", "cpu"])
    answers, slo_status, spans, rc, out, err = got
    assert rc == 0, err
    assert slo_status == want[1] == 200
    assert [a[0] for a in answers] == [a[0] for a in want[0]] == [200] * 4
    for (_, g), (_, w) in zip(answers, want[0]):
        assert (g["precision"], g["source"]) == (w["precision"], w["source"])
        assert [r["vertex"] for r in g["recommendations"]] == \
            [r["vertex"] for r in w["recommendations"]]
        np.testing.assert_allclose([r["score"] for r in g["recommendations"]],
                                   [r["score"] for r in w["recommendations"]],
                                   rtol=0, atol=0 if g["precision"] != "f32" else 1e-6)
    port_re = (re.compile(r"127\.0\.0\.1:\d+"), "127.0.0.1:<port>")
    mask = lambda lines: [port_re[0].sub(port_re[1], ln) for ln in lines
                          if not ln.startswith("otlp:")]
    assert mask(out) == mask(want[4])
    otlp, = [ln for ln in out if ln.startswith("otlp:")]
    assert otlp.endswith(", 0 dropped, 0 failed sends")
    assert int(otlp.split()[1]) == spans == want[2] > 0


_LAYOUT_WORDS = [(re.compile(r"\d+-shard mesh"), "single-device"),
                 (re.compile(r"mesh:shardx\d+"), "single"),
                 (re.compile(r"engine_sharded_"), "engine_")]


def _single_device_words(lines):
    """``--shards`` output in the single-device wording: the placement line
    dropped, the mesh's layout and engine words mapped, whitespace split."""
    out = []
    for ln in lines:
        if ln.startswith("mesh: "):
            continue
        for pat, sub in _LAYOUT_WORDS:
            ln = pat.sub(sub, ln)
        out.append(ln.split())
    return out


@pytest.mark.parametrize("argv", [["--serve", "--shards", "4"],
                                  ["--serve", "--shards", "3", "--float", "--topk", "5"],
                                  ["--shards", "8", "--bits", "20", "--kappa", "16",
                                   "--requests", "40"]],
                         ids=["Q1.25-S4", "float-S3", "Q1.19-S8-without-serve"])
def test_serve_on_a_mesh_prints_what_reference_single_device_prints(monkeypatch, capsys,
                                                                    argv):
    """``--shards N`` serves (``--serve`` implied, as in the reference) on an
    N-shard CPU mesh: one placement line, then the reference's single-device
    ``--serve`` lines with the layout words mapped, timings masked."""
    shards = argv[argv.index("--shards") + 1]
    ref_argv = [a for i, a in enumerate(argv)
                if a != "--shards" and argv[i - 1] != "--shards"]
    want = _masked(_reference(monkeypatch, capsys, ref_argv + ["--serve"]))
    got = _masked(_port(capsys, argv))
    assert got[1] == f"mesh: {shards} shards on cpu×{shards}"
    assert any(f"on {shards}-shard mesh:" in ln for ln in got)
    assert f"waves_mesh:shardx{shards}" in "\n".join(got)
    got, want = _single_device_words(got), _single_device_words(want)
    assert got[:2] == want[:2]      # the graph and the throughput lines
    assert sorted(got) == sorted(want)   # telemetry keys sort by their layout words


def test_default_device_is_cuda_and_raises_without_a_gpu(monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card; the check is for hosts without one")

    def no_graph(*a, **kw):
        raise AssertionError("a graph was built before the device was resolved")

    monkeypatch.setattr(repro_torch.graphs, "paper_graph_suite", no_graph)
    with pytest.raises(RuntimeError, match="cuda"):
        trun.main(["--scale", "0.01"])
