"""Port parity, the static analyzer: ``repro_torch.analysis`` against
``repro.analysis``, scenario by scenario.

Framework-neutral fixtures (the async pack, the suppression contract,
FXP002's width inference, FXP003) run unchanged through both analyzers and
must give equal ``to_dict()`` lists and suppressed counts.  JAX-idiom
fixtures are translated to the port's idioms (``index_add_`` and
``.to(torch.int64)`` for FXP001, ``# repro: hot-path`` in place of
``@jax.jit`` for JAX101–103 → TOR101–103) and must give the same rule at the
same line and column.  Then the fixtures the reference cannot have, the
baseline and CLI through the port's ``cli.main``, the catalogue, and the
port's own tree.

Every test of ``tests/test_analysis.py`` has its counterpart here:

| tests/test_analysis.py                                  | here                                                  |
|---------------------------------------------------------|-------------------------------------------------------|
| test_fxp001_fires_on_unguarded_raw_accumulation         | test_translated_fixture_same_rule_line_col[fxp001-fires-index_add] |
| test_fxp001_quiet_with_width_guard                      | test_translated_fixture_same_rule_line_col[fxp001-quiet-guarded] |
| test_fxp001_fires_on_raw_dot_sum                        | test_translated_fixture_same_rule_line_col[fxp001-fires-dot-sum] |
| test_fxp002_fires_when_shift_exceeds_lane               | test_neutral_fixture_equal_findings[fxp002-exceeds-lane] |
| test_fxp002_quiet_when_shift_fits_or_width_unknown      | test_neutral_fixture_equal_findings[fxp002-fits-or-unknown] |
| test_fxp002_seeds_module_level_masks                    | test_neutral_fixture_equal_findings[fxp002-module-masks] |
| test_fxp002_infers_width_across_local_calls             | test_neutral_fixture_equal_findings[fxp002-cross-function] |
| test_fxp002_quiet_on_unresolvable_callee                | test_neutral_fixture_equal_findings[fxp002-unresolvable-callee] |
| test_fxp002_constant_mask_blesses_unknown_operand       | test_neutral_fixture_equal_findings[fxp002-constant-mask] |
| test_fxp002_recursive_callee_degrades_to_unknown        | test_neutral_fixture_equal_findings[fxp002-recursion] |
| test_fxp003_fires_on_raw_times_raw_outside_mul          | test_neutral_fixture_equal_findings[fxp003-raw-times-raw] |
| test_fxp003_quiet_inside_blessed_helpers                | test_neutral_fixture_equal_findings[fxp003-blessed-mul], test_port_blessed_helpers_are_quiet |
| test_fxp003_fires_on_raw_float_literal_mix              | test_neutral_fixture_equal_findings[fxp003-float-literal{,-clean}], test_translated_fixture_same_rule_line_col[fxp003-float-literal-cast] |
| test_jax101_fires_on_sync_cast_in_jit                   | test_translated_fixture_same_rule_line_col[tor101-sync-cast] |
| test_jax101_static_shapes_and_argnames_are_exempt       | test_translated_fixture_same_rule_line_col[tor101-static-metadata] |
| test_jax101_hot_path_marker_arms_unjitted_functions     | test_translated_fixture_same_rule_line_col[tor101-marker-arms] |
| test_jax102_fires_on_host_numpy_over_traced             | test_translated_fixture_same_rule_line_col[tor102-host-numpy{,-clean}] |
| test_jax103_fires_only_inside_actual_jit                | test_translated_fixture_same_rule_line_col[tor103-if-on-tensor], test_tor103_fires_in_marked_functions_unlike_jax103 |
| test_jax103_is_none_test_is_static                      | test_translated_fixture_same_rule_line_col[tor103-is-none] |
| test_asy301_fires_on_time_sleep_in_async                | test_neutral_fixture_equal_findings[asy301-fires] |
| test_asy301_quiet_on_awaited_sleep_and_sync_defs        | test_neutral_fixture_equal_findings[asy301-quiet] |
| test_asy302_fires_on_untimed_result_in_async            | test_neutral_fixture_equal_findings[asy302-{fires,probe}] |
| test_asy303_fires_on_direct_service_drive               | test_neutral_fixture_equal_findings[asy303-fires] |
| test_asy303_quiet_when_offloaded                        | test_neutral_fixture_equal_findings[asy303-offloaded] |
| test_asy304_fires_on_discarded_submit                   | test_neutral_fixture_equal_findings[asy304-{fires,held}] |
| test_reasoned_allow_suppresses_same_line                | test_neutral_fixture_equal_findings[sup-same-line] |
| test_reasoned_allow_on_own_line_covers_next_line        | test_neutral_fixture_equal_findings[sup-own-line] |
| test_bare_allow_is_itself_a_finding_and_suppresses_nothing | test_neutral_fixture_equal_findings[sup-bare-allow] |
| test_allow_for_wrong_rule_does_not_suppress             | test_neutral_fixture_equal_findings[sup-wrong-rule] |
| test_baseline_round_trip                                | test_baseline_round_trip |
| test_cli_json_report                                    | test_cli_json_report |
| test_cli_list_rules_prints_full_catalogue               | test_cli_list_rules_prints_full_catalogue |
| test_repo_tree_is_clean_under_committed_baseline        | test_port_tree_is_clean, test_hot_markers_sit_on_the_reference_jit_counterparts |
| test_rule_catalogue_is_stable                           | test_rule_catalogue_is_stable |
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

from repro.analysis.core import analyze_paths as ref_analyze
from repro.analysis.core import get_rule as ref_get_rule
from repro_torch.analysis import FileContext, load_config
from repro_torch.analysis._astutil import func_defs
from repro_torch.analysis.cli import main as cli_main
from repro_torch.analysis.core import all_rules, analyze_paths, get_rule

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


def run(analyze, get, tmp_path, source, rule_id=None, name="mod.py"):
    """Analyze one dedented source string with one package's analyzer."""
    f = tmp_path / name
    f.write_text(textwrap.dedent(source))
    rules = None if rule_id is None else [get(rule_id)]
    return analyze([str(f)], str(tmp_path), rules=rules)


def run_port(tmp_path, source, rule_id=None, name="mod.py"):
    return run(analyze_paths, get_rule, tmp_path, source, rule_id, name)


def run_ref(tmp_path, source, rule_id=None, name="mod.py"):
    return run(ref_analyze, ref_get_rule, tmp_path, source, rule_id, name)


def rule_ids(result):
    return [f.rule_id for f in result.findings]


# ---------------------------------------------------------------------------
# framework-neutral fixtures: equal to_dict() lists through both analyzers
# (id, source, rule restricted to or None for all rules, expected rule ids,
# expected suppressed count)
# ---------------------------------------------------------------------------
NEUTRAL = [
    ("fxp002-exceeds-lane", """
        def pack():
            x = 0x3FFFFFF
            return x << 10
    """, "FXP002", ["FXP002"], 0),
    ("fxp002-fits-or-unknown", """
        def fits():
            x = 0x3FFFFFF
            return x << 4

        def unknown_operand(y):
            return y << 30
    """, "FXP002", [], 0),
    ("fxp002-module-masks", """
        _MASK16 = np.uint32(0xFFFF)

        def lift():
            return _MASK16 << 20
    """, "FXP002", ["FXP002"], 0),
    ("fxp002-cross-function", """
        def widen(v):
            return v << 4

        def overflows():
            a = 0x3FFFFFF
            b = widen(a)
            return b << 6

        def fits():
            a = 0xFFFF
            b = widen(a)
            return b << 6
    """, "FXP002", ["FXP002"], 0),
    ("fxp002-unresolvable-callee", """
        def lift(u):
            return external(u) << 30
    """, "FXP002", [], 0),
    ("fxp002-constant-mask", """
        def lift(u):
            return (u & 0xFF) << 30

        def fits(u):
            return (u & 0xFF) << 20
    """, "FXP002", ["FXP002"], 0),
    ("fxp002-recursion", """
        def spin(v):
            return spin(v << 8)

        def lift():
            a = 0x3FFFFFF
            return spin(a) << 10
    """, "FXP002", [], 0),
    ("fxp003-raw-times-raw", """
        def combine(a_raw, b_raw):
            return a_raw * b_raw
    """, "FXP003", ["FXP003"], 0),
    ("fxp003-blessed-mul", """
        def mul(a_raw, b_raw):
            return a_raw * b_raw
    """, "FXP003", [], 0),
    ("fxp003-float-literal", """
        def scale(x_raw):
            return x_raw * 0.5
    """, "FXP003", ["FXP003"], 0),
    ("fxp003-float-literal-clean", """
        def scale(x):
            return x * 0.5
    """, "FXP003", [], 0),
    ("asy301-fires", """
        import time

        async def tick():
            time.sleep(0.1)
    """, "ASY301", ["ASY301"], 0),
    ("asy301-quiet", """
        import asyncio, time

        async def tick():
            await asyncio.sleep(0.1)

        def sync_retry():
            time.sleep(0.1)
    """, "ASY301", [], 0),
    ("asy302-fires", """
        async def handler(fut):
            return fut.result()
    """, "ASY302", ["ASY302"], 0),
    ("asy302-probe", """
        async def handler(fut):
            return fut.result(timeout=0)
    """, "ASY302", [], 0),
    ("asy303-fires", """
        async def run(self):
            self.service.poll()
    """, "ASY303", ["ASY303"], 0),
    ("asy303-offloaded", """
        async def run(self, loop, ex):
            return await loop.run_in_executor(ex, self.service.poll)
    """, "ASY303", [], 0),
    ("asy304-fires", """
        async def handle(svc, q):
            svc.submit(q)
    """, "ASY304", ["ASY304"], 0),
    ("asy304-held", """
        async def handle(svc, q):
            fut = svc.submit(q)
            return fut
    """, "ASY304", [], 0),
    ("sup-same-line", """
        def combine(a_raw, b_raw):
            return a_raw * b_raw  # repro: allow[FXP003] exactness proven in tests
    """, None, [], 1),
    ("sup-own-line", """
        def combine(a_raw, b_raw):
            # repro: allow[FXP003] exactness proven in tests
            return a_raw * b_raw
    """, None, [], 1),
    ("sup-bare-allow", """
        def combine(a_raw, b_raw):
            return a_raw * b_raw  # repro: allow[FXP003]
    """, None, ["FXP003", "SUP000"], 0),
    ("sup-wrong-rule", """
        def combine(a_raw, b_raw):
            return a_raw * b_raw  # repro: allow[FXP001] not the rule that fires
    """, None, ["FXP003"], 0),
]


@pytest.mark.parametrize("source,rule,want,suppressed",
                         [case[1:] for case in NEUTRAL],
                         ids=[case[0] for case in NEUTRAL])
def test_neutral_fixture_equal_findings(tmp_path, source, rule, want, suppressed):
    ref = run_ref(tmp_path, source, rule)
    port = run_port(tmp_path, source, rule)
    assert [f.to_dict() for f in port.findings] == [f.to_dict() for f in ref.findings]
    assert port.suppressed == ref.suppressed == suppressed
    assert sorted(rule_ids(port)) == want
    if rule == "FXP002" and want:
        assert "exceeds the 32-bit lane" in port.findings[0].message
    if "widen(a)" in source:
        assert "~30-bit" in port.findings[0].message


# ---------------------------------------------------------------------------
# JAX-idiom fixtures translated to the port's idioms: the same rule (JAX10x
# → TOR10x) at the same line and column
# (id, reference source, port source, rule, expected reference rule ids)
# ---------------------------------------------------------------------------
TRANSLATED = [
    ("fxp001-fires-index_add", """
        def accumulate(raw_vals, seg):
            return segment_sum(raw_vals, seg)
    """, """
        def accumulate(raw_vals, seg, acc):
            return acc.index_add_(0, seg, raw_vals)
    """, "FXP001", ["FXP001"]),
    ("fxp001-quiet-guarded", """
        def accumulate(raw_vals, seg, raw_acc):
            a = segment_sum(raw_vals.astype(jnp.int64), seg)
            b = raw_acc.astype(jnp.int32).sum(0)
            return a + b
    """, """
        def accumulate(raw_vals, seg, raw_acc, acc, n):
            a = acc.index_add_(0, seg, raw_vals.to(torch.int64))
            b = raw_acc.long().sum(0) + torch.sum(widen_u32(raw_acc), 0)
            c = torch.zeros(n, dtype=torch.int64).index_add_(0, seg, raw_vals)
            return a + b + c
    """, "FXP001", []),
    ("fxp001-fires-dot-sum", """
        def total(raw_acc):
            return raw_acc.sum(0)
    """, """
        def total(raw_acc):
            return raw_acc.sum(0)
    """, "FXP001", ["FXP001"]),
    ("fxp003-float-literal-cast", """
        def scale(x_raw):
            y = x_raw.astype(jnp.float32) * 0.5
            return x_raw * 0.5
    """, """
        def scale(x_raw):
            y = x_raw.to(torch.float32) * 0.5 + x_raw.double() * 0.5
            return x_raw * 0.5
    """, "FXP003", ["FXP003"]),
    ("tor101-sync-cast", """
        @jax.jit
        def step(x):
            return float(x)
    """, """
        # repro: hot-path
        def step(x):
            return float(x)
    """, "101", ["JAX101"]),
    ("tor101-static-metadata", """
        @functools.partial(jax.jit, static_argnames=("n",))
        def step(x, n):
            rows = float(x.shape[0])
            return x * (rows + int(n))
    """, """
        # repro: hot-path
        def step(x, n: int):
            rows = float(x.shape[0]) + int(x.size(0)) + int(x.numel())
            return x * (rows + int(n))
    """, "101", []),
    ("tor101-marker-arms", """
        # repro: hot-path
        def step(x):
            return x.item()
    """, """
        # repro: hot-path
        def step(x):
            return x.item()
    """, "101", ["JAX101"]),
    ("tor102-host-numpy", """
        @jax.jit
        def rank(x):
            return np.argsort(x)
    """, """
        # repro: hot-path
        def rank(x):
            return np.argsort(x)
    """, "102", ["JAX102"]),
    ("tor102-host-numpy-clean", """
        @jax.jit
        def rank(x):
            return jnp.argsort(x)
    """, """
        # repro: hot-path
        def rank(x):
            return torch.argsort(x)
    """, "102", []),
    ("tor103-if-on-tensor", """
        @jax.jit
        def clamp(x):
            if x > 0:
                return x
            return -x
    """, """
        # repro: hot-path
        def clamp(x):
            if x > 0:
                return x
            return -x
    """, "103", ["JAX103"]),
    ("tor103-is-none", """
        @jax.jit
        def seed(x, warm):
            if warm is None:
                return x
            return warm
    """, """
        # repro: hot-path
        def seed(x, warm):
            if warm is None:
                return x
            return warm
    """, "103", []),
]


def _port_rule(rule: str) -> str:
    return rule if rule.startswith("FXP") else "TOR" + rule


def _ref_rule(rule: str) -> str:
    return rule if rule.startswith("FXP") else "JAX" + rule


@pytest.mark.parametrize("ref_src,port_src,rule,want",
                         [case[1:] for case in TRANSLATED],
                         ids=[case[0] for case in TRANSLATED])
def test_translated_fixture_same_rule_line_col(tmp_path, ref_src, port_src, rule, want):
    ref = run_ref(tmp_path, ref_src, _ref_rule(rule), name="ref.py")
    port = run_port(tmp_path, port_src, _port_rule(rule), name="port.py")
    assert rule_ids(ref) == want
    mapped = [r.replace("JAX", "TOR") for r in want]
    assert rule_ids(port) == mapped
    assert ([(f.line, f.col) for f in port.findings]
            == [(f.line, f.col) for f in ref.findings])


def test_fxp001_message_names_the_port_guard(tmp_path):
    r = run_port(tmp_path, """
        def total(raw_acc):
            return raw_acc.sum(0)
    """, "FXP001")
    assert ".to(torch.int64)" in r.findings[0].message
    assert "26 bits" in r.findings[0].message


def test_tor103_fires_in_marked_functions_unlike_jax103(tmp_path):
    """Eager PyTorch branches on a tensor by an implicit bool() — a sync, not
    a retrace — so TOR103 fires where JAX103 stays quiet (a marked, unjitted
    function), and stays quiet outside a hot context."""
    src = """
        # repro: hot-path
        def clamp(x):
            if x > 0:
                return x
            return -x

        def cold(x):
            while x.sum() > 0:
                x = x - 1
            return x
    """
    assert rule_ids(run_ref(tmp_path, src, "JAX103", name="ref.py")) == []
    port = run_port(tmp_path, src, "TOR103", name="port.py")
    assert rule_ids(port) == ["TOR103"] and port.findings[0].line == 4


# ---------------------------------------------------------------------------
# fixtures the reference cannot have: the port's own idioms
# (id, source, rule, expected rule ids)
# ---------------------------------------------------------------------------
PORT_ONLY = [
    ("fxp001-index_add-of-mul", """
        def spmv(acc, x, fmt, a_raw, b_raw):
            return acc.index_add_(0, x, fmt.mul(a_raw, b_raw))
    """, "FXP001", ["FXP001"]),
    ("fxp001-index_add-of-mul-guarded", """
        def spmv(acc, x, fmt, a_raw, b_raw):
            return acc.index_add_(0, x, fmt.mul(a_raw, b_raw).to(torch.int64))
    """, "FXP001", []),
    ("fxp001-guard-through-assignment-and-mask", """
        def spmv_fixed(x, y, val_raw, p_raw, n, fmt):
            prod = fmt.mul(val_raw[:, None], p_raw[y.long()]).to(torch.int64) & 0xFFFFFFFF
            acc = torch.zeros((n, p_raw.shape[1]), dtype=torch.int64)
            acc.index_add_(0, x.long(), prod)
            return wrap_u32(acc)
    """, "FXP001", []),
    ("fxp001-int64-accumulator", """
        def spmv(x, n, fmt, a_raw, b_raw):
            acc = torch.zeros(n, dtype=torch.int64)
            return acc.index_add_(0, x, fmt.mul(a_raw, b_raw))
    """, "FXP001", []),
    ("fxp001-int32-is-no-guard", """
        def spmv(x, n, fmt, a_raw, b_raw):
            acc = torch.zeros(n, dtype=torch.int32)
            return acc.index_add_(0, x, fmt.mul(a_raw, b_raw).to(torch.int32))
    """, "FXP001", ["FXP001"]),
    ("fxp001-scatter_add-and-torch.sum", """
        def sums(acc, x, p_raw):
            a = acc.scatter_add_(0, x, p_raw)
            b = torch.sum(p_raw, 0)
            c = torch.sum(p_raw, 0, dtype=torch.int64)
            d = torch.index_add(acc, 0, x, p_raw)
            return a, b, c, d
    """, "FXP001", ["FXP001", "FXP001", "FXP001"]),
    ("fxp001-int64-product-then-sum", """
        def dangling_mass(d_raw, P):
            return wrap_u32((d_raw.to(torch.int64)[:, None] * widen_u32(P)).sum(0))
    """, "FXP001", []),
    ("fxp003-widened-raw-times-raw", """
        def combine(a_raw, b_raw):
            return widen_u32(a_raw) * widen_u32(b_raw)
    """, "FXP003", ["FXP003"]),
    ("fxp003-float-cast-clears", """
        def delta(p_raw, q_raw):
            d = torch.abs(widen_u32(p_raw).to(torch.float32)
                          - widen_u32(q_raw).float())
            return (d * d).sum(0)
    """, "FXP003", []),
    ("tor101-cpu-in-marked", """
        # repro: hot-path
        def step(x):
            return x.cpu()
    """, "TOR101", ["TOR101"]),
    ("tor101-numpy-tolist-bool", """
        # repro: hot-path
        def step(x, y):
            a = x.numpy()
            b = y.tolist()
            return bool(x.max() == 0)
    """, "TOR101", ["TOR101", "TOR101", "TOR101"]),
    ("tor101-unmarked-is-exempt", """
        def telemetry(x):
            return x.cpu().item()
    """, "TOR101", []),
    ("tor101-nested-def-inherits", """
        def make_step(fmt):
            # repro: hot-path
            def outer(P):
                def inner(x):
                    return x.item()
                return inner(P)
            return outer
    """, "TOR101", ["TOR101"]),
    ("tor103-metadata-and-host-scalars", """
        # repro: hot-path
        def topk(P, k: int, exclude=None):
            kk = k if exclude is None else k + 1
            v, kappa = P.shape
            if kk > v or P.dim() != 2 or len(P) == 0:
                raise ValueError(kk)
            while P.numel() > kk:
                break
            return P
    """, "TOR103", []),
    ("tor103-while-on-tensor", """
        # repro: hot-path
        def iterate(P, tol):
            res = (P - P.roll(1)).abs().max()
            while res > tol:
                res = res / 2
            return res
    """, "TOR103", ["TOR103"]),
]


@pytest.mark.parametrize("source,rule,want", [case[1:] for case in PORT_ONLY],
                         ids=[case[0] for case in PORT_ONLY])
def test_port_only_fixture(tmp_path, source, rule, want):
    assert rule_ids(run_port(tmp_path, source, rule)) == want


@pytest.mark.parametrize("helper", ["mul", "add", "mul_raw", "widen_u32", "wrap_u32",
                                    "to_float", "from_float", "quantize_raw",
                                    "quantize_f32"])
def test_port_blessed_helpers_are_quiet(tmp_path, helper):
    r = run_port(tmp_path, f"""
        def {helper}(a_raw, b_raw):
            return a_raw * b_raw
    """, "FXP003")
    assert rule_ids(r) == []


# ---------------------------------------------------------------------------
# baseline round trip + CLI surface
# ---------------------------------------------------------------------------
VIOLATION = "def combine(a_raw, b_raw):\n    return a_raw * b_raw\n"
CLEAN = "def combine(a, b):\n    return a * b\n"


def test_baseline_round_trip(tmp_path, capsys):
    mod = tmp_path / "mod.py"
    mod.write_text(VIOLATION)
    root = str(tmp_path)

    # no baseline yet: the finding fails the run
    assert cli_main([str(mod), "--root", root]) == 1

    # record it, then the same tree passes --check
    assert cli_main([str(mod), "--root", root, "--write-baseline"]) == 0
    assert (tmp_path / "ANALYSIS_torch_baseline.json").exists()
    assert not (tmp_path / "ANALYSIS_baseline.json").exists()
    assert cli_main([str(mod), "--root", root, "--check"]) == 0

    # a NEW violation (same rule, same message — multiset budget) still fails
    mod.write_text(VIOLATION + "\n\ndef again(c_raw, d_raw):\n"
                   "    return c_raw * d_raw\n")
    assert cli_main([str(mod), "--root", root, "--check"]) == 1

    # fixing everything leaves a stale ledger entry: --check fails (the
    # ledger only shrinks), a plain run passes
    mod.write_text(CLEAN)
    assert cli_main([str(mod), "--root", root]) == 0
    assert cli_main([str(mod), "--root", root, "--check"]) == 1
    out = capsys.readouterr().out
    assert "stale baseline entry" in out


def test_cli_json_report(tmp_path):
    mod = tmp_path / "mod.py"
    mod.write_text(VIOLATION)
    report = tmp_path / "report.json"
    rc = cli_main([str(mod), "--root", str(tmp_path), "--json", str(report)])
    assert rc == 1
    payload = json.loads(report.read_text())
    assert payload["version"] == 1
    assert payload["files_scanned"] == 1
    assert payload["baselined"] == 0
    assert [f["rule"] for f in payload["findings"]] == ["FXP003"]
    f = payload["findings"][0]
    assert f["path"] == "mod.py" and f["line"] == 2


def test_cli_usage_errors_exit_2(tmp_path, capsys):
    with pytest.raises(SystemExit) as exc:
        cli_main(["--root", str(tmp_path / "missing")])
    assert exc.value.code == 2
    (tmp_path / "ANALYSIS_torch_baseline.json").write_text('{"version": 9}')
    (tmp_path / "mod.py").write_text(CLEAN)
    assert cli_main([str(tmp_path / "mod.py"), "--root", str(tmp_path)]) == 2


# CI's negative self-test, redone for the port: one injected violation per
# rule pack must make the CLI exit non-zero
INJECTED = {
    "fxp_bad.py": VIOLATION,
    "tor_bad.py": "# repro: hot-path\ndef step(x):\n    return float(x)\n",
    "asy_bad.py": "import time\n\nasync def tick():\n    time.sleep(0.1)\n",
}


@pytest.mark.parametrize("name", sorted(INJECTED))
def test_cli_rejects_one_injected_violation_per_pack(tmp_path, name):
    bad = tmp_path / name
    bad.write_text(INJECTED[name])
    assert cli_main([str(bad), "--root", str(tmp_path)]) == 1


CATALOGUE = ("FXP001", "FXP002", "FXP003", "TOR101", "TOR102", "TOR103",
             "ASY301", "ASY302", "ASY303", "ASY304")


def test_cli_list_rules_prints_full_catalogue(capsys):
    assert cli_main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rid in CATALOGUE:
        assert rid in out
    assert "JAX1" not in out


def test_rule_catalogue_is_stable():
    ids = [r.id for r in all_rules()]
    assert ids == sorted(ids) and len(ids) == len(set(ids))
    assert set(ids) == set(CATALOGUE)


# ---------------------------------------------------------------------------
# the port's own tree
# ---------------------------------------------------------------------------
def test_port_tree_is_clean():
    """The acceptance gate, as a test: the shipped port analyzes clean with
    no baseline file, and its config reads the port's precision ladder."""
    assert not os.path.exists(os.path.join(ROOT, "ANALYSIS_torch_baseline.json"))
    result = analyze_paths(["src/repro_torch", "examples_torch"], ROOT)
    assert [f.render() for f in result.findings] == []
    assert result.suppressed >= 1
    assert load_config(ROOT).max_format_bits == 26


def test_committed_report_matches_the_tree():
    with open(os.path.join(ROOT, "ANALYSIS_torch_findings.json")) as fh:
        report = json.load(fh)
    result = analyze_paths(["src/repro_torch", "examples_torch"], ROOT)
    assert report["findings"] == []
    assert report["suppressed"] == result.suppressed
    assert report["files_scanned"] == result.files_scanned


# the counterparts of the reference's eight jitted functions
# (src/repro/core/ppr.py:120,135,161,185,199,226 and ppr_serving/topk.py:56,71)
HOT = {
    "src/repro_torch/core/ppr.py": ["ppr_step_float", "step", "step", "step",
                                    "ppr_float", "run"],
    "src/repro_torch/ppr_serving/topk.py": ["topk_dense", "topk_streaming"],
}


def _marked(rel):
    ctx = FileContext.parse(os.path.join(ROOT, rel), rel, load_config(ROOT))
    return ctx, [fn.name for fn in func_defs(ctx.tree) if ctx.is_marked_hot(fn)]


@pytest.mark.parametrize("rel", sorted(HOT))
def test_hot_markers_sit_on_the_reference_jit_counterparts(rel):
    _, names = _marked(rel)
    assert sorted(names) == sorted(HOT[rel])


def test_no_other_function_of_the_port_is_marked_hot():
    marked = {}
    for dirpath, _, files in os.walk(os.path.join(ROOT, "src", "repro_torch")):
        for f in files:
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(dirpath, f), ROOT).replace(os.sep, "/")
                names = _marked(rel)[1]
                if names:
                    marked[rel] = sorted(names)
    assert marked == {k: sorted(v) for k, v in HOT.items()}


def test_port_idioms_are_seen_by_the_rules(tmp_path):
    """The port's real raw sum (``core/spmv.py``'s ``index_add_``) is visible
    to FXP001: with its int64 guard removed the rule fires."""
    with open(os.path.join(ROOT, "src/repro_torch/core/spmv.py")) as fh:
        src = fh.read()
    guarded = "fmt.mul(val_raw[:, None], p_raw[y.long()]).to(torch.int64) & 0xFFFFFFFF"
    assert guarded in src
    broken = src.replace(guarded, "fmt.mul(val_raw[:, None], p_raw[y.long()])").replace(
        "dtype=torch.int64", "dtype=torch.int32")
    (tmp_path / "spmv.py").write_text(broken)
    r = analyze_paths([str(tmp_path / "spmv.py")], str(tmp_path), rules=[get_rule("FXP001")])
    assert rule_ids(r) == ["FXP001"]


def test_analyzer_is_stdlib_only():
    """``python -m repro_torch.analysis`` runs where neither torch nor JAX is
    installed: importing it loads neither."""
    code = ("import sys, repro_torch.analysis.cli\n"
            "bad = sorted(m for m in ('torch', 'jax', 'numpy', 'repro') if m in sys.modules)\n"
            "assert not bad, bad\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=60, env=dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src")))
    assert out.returncode == 0, out.stderr
