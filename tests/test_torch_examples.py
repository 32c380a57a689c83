"""Port parity, the examples: ``examples_torch/`` against ``examples/``.

Every script compiles.  ``quickstart.py``, ``ppr_recommender.py`` and
``http_serving.py`` run with ``--device cpu`` as subprocesses beside the
reference's scripts, all at once (a module fixture), and their lines are
equal once the clocks are masked: the top-K lists before and after the delta,
cache and wave sources, the callback, the grown vertex's list and the
telemetry line; the oracle overlaps, top-3 lists, cache hits and the auto
precision's shadow NDCG; the HTTP tier's ordinary traffic (statuses, sources,
top-5 lists, the 400).  How the HTTP burst splits into served and shed
depends on how fast a wave drains the queue against the arrivals — the
reference's own script serves 11 and sheds 21 on a quiet host, 16 and 16 on
a busy one — so from the burst on both are held to invariants: 32 answered,
some shed, the same audit keys, shedding engaged and then recovered, and
the same span names.  Without a GPU, each script run without
``--device cpu`` exits non-zero and names the device.  ``serve_lm.py`` and
``train_lm.py`` only compile here: train_lm's ~150M-parameter model is the
card's job (``chip_smoke.py`` phase 14).
"""
import glob
import os
import re
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = sorted(glob.glob(os.path.join(ROOT, "examples_torch", "*.py")))
NAMES = [os.path.basename(p) for p in EXAMPLES]
COMPARED = ("quickstart.py", "ppr_recommender.py", "http_serving.py")
TIMEOUT_S = 300

# the clocks in the examples' lines
_CLOCKS = [
    (re.compile(r"http://127\.0\.0\.1:\d+"), "http://127.0.0.1:<port>"),
    (re.compile(r"t=\d+\.\d+s"), "t=<s>"),
    (re.compile(r" +\d+(?:\.\d+)? ms\b"), " <ms> ms"),
    (re.compile(r"\(\d+ queries/s"), "(<r> queries/s"),
]


def _masked(stdout):
    lines = stdout.splitlines()
    for pattern, repl in _CLOCKS:
        lines = [pattern.sub(repl, line) for line in lines]
    return lines


def _start(script, args=(), threads=None):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    if threads is not None:
        env["OMP_NUM_THREADS"] = str(threads)
    return subprocess.Popen([sys.executable, script, *args], cwd=ROOT, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _finish(proc):
    try:
        out, err = proc.communicate(timeout=TIMEOUT_S)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
    return proc.returncode, out, err


@pytest.fixture(scope="module")
def runs():
    """Every run this file compares: the reference's and the port's
    ``--device cpu`` runs of the three PPR scripts, started together (the
    port's on two threads each, so six processes share the host), then each
    port script without ``--device``."""
    procs = {}
    for name in COMPARED:
        procs["ref", name] = _start(os.path.join(ROOT, "examples", name))
        procs["port", name] = _start(os.path.join(ROOT, "examples_torch", name),
                                     ["--device", "cpu"], threads=2)
    out = {key: _finish(proc) for key, proc in procs.items()}
    procs = {("default", name): _start(os.path.join(ROOT, "examples_torch", name),
                                       threads=1) for name in NAMES}
    out.update({key: _finish(proc) for key, proc in procs.items()})
    return out


def test_examples_exist():
    assert NAMES == sorted(["http_serving.py", "ppr_recommender.py", "quickstart.py",
                            "serve_lm.py", "train_lm.py"])


@pytest.mark.parametrize("path", EXAMPLES, ids=NAMES)
def test_example_compiles(path):
    with open(path) as f:
        compile(f.read(), path, "exec")


def _ok(runs, name):
    rrc, rout, rerr = runs["ref", name]
    prc, pout, perr = runs["port", name]
    assert rrc == 0, rerr[-3000:]
    assert prc == 0, perr[-3000:]
    return _masked(rout), _masked(pout)


@pytest.mark.parametrize("name", ["quickstart.py", "ppr_recommender.py"])
def test_example_prints_the_reference_lines(runs, name):
    ref, port = _ok(runs, name)
    assert port == ref


def _burst_on(lines):
    """The burst's served and shed counts, the audit's keys, the timeline's
    event names and the span names of the burst query's tree."""
    i = next(i for i, line in enumerate(lines) if line.startswith("burst of 32:"))
    served, shed = map(int, re.search(r"(\d+) served .*?(\d+) shed", lines[i]).groups())
    keys = [line.split()[0] for line in lines[i + 2:] if line.startswith("  ")
            and not line.lstrip().startswith("t=")][:11]
    events = [re.match(r" +t=<s> (\w+)", line).group(1) for line in lines
              if re.match(r" +t=<s> ", line)]
    tree = lines.index("flight recorder — one burst query's span tree:")
    spans = [line.split()[0] for line in lines[tree + 2:-1]]
    return lines[:i], served, shed, keys, events, spans


def test_http_example_prints_the_reference_lines(runs):
    ref, port = _ok(runs, "http_serving.py")
    r_head, r_served, r_shed, r_keys, r_events, r_spans = _burst_on(ref)
    p_head, p_served, p_shed, p_keys, p_events, p_spans = _burst_on(port)
    assert p_head == r_head                      # the ordinary traffic
    assert p_served + p_shed == r_served + r_shed == 32
    assert p_shed > 0 and r_shed > 0
    assert p_keys == r_keys
    for events in (p_events, r_events):
        assert events.index("shed_engaged") < events.index("shed_recovered")
    assert p_spans == r_spans
    assert port[-1] == ref[-1] == "server stopped"


def test_quickstart_serves_the_grown_vertex(runs):
    out = runs["port", "quickstart.py"][1]
    assert "delta applied" in out
    assert "user  2000" in out
    assert "telemetry:" in out


def test_recommender_matches_the_oracle_and_serves_auto(runs):
    out = runs["port", "ppr_recommender.py"][1]
    assert out.count("top-10 overlap with oracle 10/10") == 6
    assert "repeat traffic: 20/20 served from cache" in out
    assert re.search(r"auto precision \(NDCG target 0\.95\): served at \['Q1\.\d+'\]", out)


@pytest.mark.parametrize("name", NAMES)
def test_example_without_a_gpu_refuses_and_names_the_device(runs, name):
    torch = pytest.importorskip("torch")
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device runs")
    rc, out, err = runs["default", name]
    assert rc != 0
    assert "device 'cuda' requested" in err
