"""Checkpointing and fault tolerance in the port: the counterparts of
``tests/test_checkpoint.py`` (atomic roundtrip, keep-k GC, no ``.tmp`` left,
resume equal to an uninterrupted run, simulated node failure), the host
copy ``save_async`` takes before its thread starts, ``restore(device=)``,
and ``launch.train --smoke --device cpu`` run, stopped and resumed from its
checkpoint.  Everything runs on the CPU, where the steps are deterministic:
a resumed run equals an uninterrupted one bit for bit.
"""
import dataclasses
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.data import DataConfig, synthetic_batch  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.training import (  # noqa: E402
    AdamWConfig,
    FaultConfig,
    init_train_state,
    latest_step,
    make_train_step,
    restore,
    run_resumable,
    save,
    save_async,
    wait_pending,
)
from repro_torch.training import checkpoint as ckpt  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def setup():
    cfg = dataclasses.replace(smoke_config(get_config("gemma-2b")), compute_dtype="float32",
                              num_layers=2, layer_pattern=(0, 0))
    api = build_model(cfg, device="cpu", remat=False)
    step = make_train_step(api.loss_fn, AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=40))
    return cfg, api, step, DataConfig(seq_len=16, global_batch=4)


def _state(api, seed=0, compress=False):
    return init_train_state(api.init_params(torch.Generator().manual_seed(seed)),
                            compress=compress)


def _leaves(state):
    return ckpt._flatten_with_paths(state)


def test_roundtrip(tmp_path, setup):
    cfg, api, step, dcfg = setup
    state, _ = step(_state(api, compress=True), synthetic_batch(cfg, dcfg, 0, device="cpu"))
    save(str(tmp_path), 7, state)
    assert latest_step(str(tmp_path)) == 7
    back = restore(str(tmp_path), 7, _state(api, seed=1, compress=True))
    want, got = _leaves(state), _leaves(back)
    assert sorted(want) == sorted(got) and "opt/step" in got and "residual/embed" in got
    for k, v in want.items():
        assert got[k].dtype == v.dtype and torch.equal(got[k], v), k
    assert all(p.requires_grad for p in back.params.parameters())


def test_keep_k_gc(tmp_path, setup):
    _, api, _, _ = setup
    state = _state(api)
    for s in (1, 2, 3, 4, 5):
        save(str(tmp_path), s, state, keep=2)
    assert sorted(os.listdir(tmp_path)) == ["step_00000004", "step_00000005"]


def test_atomic_no_tmp_left(tmp_path, setup):
    _, api, _, _ = setup
    save(str(tmp_path), 1, _state(api))
    assert not any(d.endswith(".tmp") for d in os.listdir(tmp_path))
    meta = (tmp_path / "step_00000001" / "meta.json").read_text()
    assert '"step": 1' in meta and "params/embed" in meta


def test_restore_onto_a_device(tmp_path, setup):
    """``restore(device=)`` takes the place of the reference's shardings:
    every tensor lands on the device asked for."""
    _, api, _, _ = setup
    params = api.init_params(torch.Generator().manual_seed(0))
    save(str(tmp_path), 3, params)
    back = restore(str(tmp_path), 3, api.init_params(torch.Generator().manual_seed(1)),
                   device="cpu")
    assert all(p.device.type == "cpu" for p in back.parameters())
    assert all(torch.equal(a, b) for a, b in zip(params.parameters(), back.parameters()))


def test_save_async_copies_before_its_thread_starts(tmp_path, setup, monkeypatch):
    """The tensors are copied to the host before the writer thread runs: an
    in-place update right after ``save_async`` does not reach the file."""
    _, api, _, _ = setup
    state = _state(api)
    gate = threading.Event()
    real_save = ckpt.save

    def slow_save(*a, **kw):
        gate.wait(timeout=30)
        return real_save(*a, **kw)

    monkeypatch.setattr(ckpt, "save", slow_save)
    want = state.params.embed.detach().clone()
    t = save_async(str(tmp_path), 2, state)
    with torch.no_grad():
        state.params.embed.add_(1.0)      # the next step's in-place update
    gate.set()
    wait_pending()
    assert not t.is_alive()
    back = restore(str(tmp_path), 2, _state(api, seed=1))
    assert torch.equal(back.params.embed, want)


def test_resume_equals_uninterrupted(tmp_path, setup):
    """Crash at step 6 (after the checkpoint at step 5), restart: the
    parameters after 10 steps equal the uninterrupted run's (bit for bit on
    the CPU; the reference's test allows rtol 1e-6 / atol 1e-7)."""
    cfg, api, step, dcfg = setup

    def batch_fn(s):
        return synthetic_batch(cfg, dcfg, s, device="cpu")

    ref = _state(api)
    for s in range(10):
        ref, _ = step(ref, batch_fn(s))
    fault = FaultConfig(ckpt_dir=str(tmp_path / "ft"), save_every=5, max_steps=10)
    with pytest.raises(RuntimeError, match="simulated node failure"):
        run_resumable(fault, lambda: _state(api), step, batch_fn, fail_at_step=6)
    wait_pending()
    assert latest_step(fault.ckpt_dir) == 5
    state, steps_run, _ = run_resumable(fault, lambda: _state(api), step, batch_fn)
    assert steps_run == 5
    assert int(state.opt.step) == 10
    for (n, a), b in zip(ref.params.named_parameters(), state.params.parameters()):
        assert torch.equal(a, b), n
    for k in ref.opt.mu:
        assert torch.equal(ref.opt.mu[k], state.opt.mu[k])
        assert torch.equal(ref.opt.nu[k], state.opt.nu[k])


def test_simulated_failure_leaves_the_last_checkpoint(tmp_path, setup):
    """A failure between saves loses only the steps since the last save;
    metrics reach ``on_metrics`` for every step run."""
    cfg, api, step, dcfg = setup
    seen = []
    fault = FaultConfig(ckpt_dir=str(tmp_path), save_every=2, keep=2, max_steps=6)
    with pytest.raises(RuntimeError, match="at step 5"):
        run_resumable(fault, lambda: _state(api), step,
                      lambda s: synthetic_batch(cfg, dcfg, s, device="cpu"),
                      on_metrics=lambda s, m: seen.append((s, float(m["loss"]))),
                      fail_at_step=5)
    assert [s for s, _ in seen] == [0, 1, 2, 3, 4]
    assert all(np.isfinite(x) for _, x in seen)
    assert sorted(os.listdir(tmp_path)) == ["step_00000002", "step_00000004"]


def test_train_launcher_runs_stops_and_resumes(tmp_path):
    """``launch.train --smoke --device cpu``: 4 steps with a save every 2,
    then again with ``--steps 6``, which resumes at step 4 and runs 2."""
    def run(steps):
        return subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.train", "--arch", "whisper-medium",
             "--smoke", "--device", "cpu", "--steps", str(steps), "--seq", "16",
             "--batch", "2", "--save-every", "2", "--log-every", "1",
             "--ckpt-dir", str(tmp_path)],
            capture_output=True, text=True, timeout=120, cwd=ROOT,
            env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))

    first = run(4)
    assert first.returncode == 0, first.stderr
    assert "step     0 loss" in first.stdout and "done: ran 4 steps" in first.stdout
    assert "timing: 3 steps after the first" in first.stdout
    assert "s after start" in first.stdout
    assert sorted(os.listdir(tmp_path))[-1] == "step_00000004"
    second = run(6)
    assert second.returncode == 0, second.stderr
    assert "step     4 loss" in second.stdout and "step     3 loss" not in second.stdout
    assert "done: ran 2 steps" in second.stdout
    assert latest_step(str(tmp_path)) == 6


def test_train_launcher_runs_on_cuda_unless_asked_for_the_cpu(monkeypatch):
    """``launch.train`` defaults to ``--device cuda`` and raises on a host
    without a card; it never carries on on the CPU by itself."""
    from repro_torch.launch import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train.main(["--arch", "gemma-2b", "--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        synthetic_batch(smoke_config(get_config("gemma-2b")), DataConfig(8, 2), 0)
