"""Port parity, the dry-run drivers' command lines: each of
``launch.dryrun``, ``launch.roofline_run`` and ``launch.ppr_dryrun`` run once
as a subprocess into ``tmp_path`` (each builds its own ``"fake"`` group of
512 ranks), with the reference's JSON keys and ``PASS`` / ``SKIP`` lines;
and ``structured_roofline``'s refusal of the reference's component
builders.
"""
import json
import os
import subprocess
import sys
import types

import pytest

torch = pytest.importorskip("torch")

from torch_dryrun_cells import ROOFLINE_KEYS  # noqa: E402

from repro_torch.configs import LONG_SKIP_REASON, cells, get_config  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env.update(extra)
    return env


def test_skipped_cells_print_the_reference_reasons(tmp_path):
    skipped = [(a, s, why) for a, s, ok, why in cells() if not ok]
    assert {a for a, _, _ in skipped} == set(LONG_SKIP_REASON)
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--shape", "long_500k",
         "--arch", "gemma-2b", "--mesh", "single", "--out", str(tmp_path)],
        capture_output=True, text=True, timeout=300, env=_env())
    assert out.returncode == 0, out.stderr
    assert (f"SKIP  {'single_pod_16x16':18s} {'gemma-2b':22s} long_500k: "
            f"{LONG_SKIP_REASON['gemma-2b']}") in out.stdout
    assert "ALL CELLS PASS" in out.stdout


def _cli(args, tmp_path, timeout=600):
    out = subprocess.run([sys.executable, "-m"] + args + ["--out", str(tmp_path)],
                         capture_output=True, text=True, timeout=timeout, env=_env())
    assert out.returncode == 0, f"stdout:\n{out.stdout}\nstderr:\n{out.stderr}"
    return out.stdout


def test_cli_ppr_dryrun(tmp_path):
    stdout = _cli(["repro_torch.launch.ppr_dryrun", "--workload", "ppr-paper-1m"], tmp_path)
    for mesh, chips in (("single_pod_16x16", 256), ("multi_pod_2x16x16", 512)):
        assert f"PASS  {mesh:18s} ppr-paper-1m" in stdout
        with open(tmp_path / f"ppr__ppr-paper-1m__{mesh}.json") as f:
            rec = json.load(f)
        assert set(rec) == {"workload", "mesh", "V", "E", "kappa_total", "flops_per_device",
                            "bytes_per_device", "collective_bytes_per_device", "collectives",
                            "memory_s", "collective_s"}
        assert rec["kappa_total"] == 16 * chips // 16
        assert rec["collectives"] == {"all-gather": (1 << 20) * 16 * 4}


def test_cli_dryrun_and_roofline_run_full_size_decode(tmp_path):
    stdout = _cli(["repro_torch.launch.dryrun", "--arch", "gemma-2b", "--shape",
                   "decode_32k", "--mesh", "single"], tmp_path)
    assert "PASS  single_pod_16x16" in stdout and "ALL CELLS PASS" in stdout
    with open(tmp_path / "single_pod_16x16" / "gemma-2b__decode_32k.json") as f:
        rec = json.load(f)
    assert rec["params"] == get_config("gemma-2b").param_count() and rec["chips"] == 256
    stdout = _cli(["repro_torch.launch.roofline_run", "--arch", "gemma-2b", "--shape",
                   "decode_32k"], tmp_path)
    assert "OK    gemma-2b" in stdout and "ALL STRUCTURED ROOFLINES DONE" in stdout
    with open(tmp_path / "baseline" / "gemma-2b__decode_32k.json") as f:
        rec = json.load(f)
    assert ROOFLINE_KEYS - {"peak_flops"} <= set(rec)
    assert rec["variant"] == "baseline" and rec["chips"] == 256


def test_roofline_run_refuses_a_component_builder():
    from repro_torch.configs import SHAPES
    from repro_torch.launch.roofline_run import VARIANTS, resolve_overrides
    from repro_torch.roofline.structured import structured_roofline

    mesh = types.SimpleNamespace(axis_names=("data", "model"), shape={"data": 16, "model": 16})
    for bad in ({"decode_attn_body": object()}, {"group": object()}):
        with pytest.raises(NotImplementedError, match="no counterpart"):
            structured_roofline(get_config("gemma-2b"), SHAPES["decode_32k"], mesh,
                                overrides=bad)
    assert resolve_overrides("it_windowed_kv", SHAPES["decode_32k"])["cache_len"](4096) == 4096
    assert resolve_overrides("it_windowed_kv", SHAPES["decode_32k"])["cache_len"](0) == 32768
    assert "baseline" in VARIANTS and "it_compressed_ar" in VARIANTS
