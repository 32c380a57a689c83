"""Port parity, LM serving slice: gemma-2b (smoke widths, float32) in the port
against the JAX reference, on the same parameters.

The reference's ``init_params(PRNGKey(0))`` is carried into the port by
``convert.lm_params_from_jax``; both packages then run forward, prefill,
decode and the serving engine on the same tokens.  Tolerance for logits and
caches: rtol = atol = 2e-5.  Measured on these fixtures, the largest
difference is 7.7e-7 in the logits and 2.3e-6 in the cache (float32 sums in
another order); the reference's own decode-vs-forward test allows
2e-3 / 2e-4.  Served tokens must be identical.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as rget_config  # noqa: E402
from repro.configs import smoke_config as rsmoke  # noqa: E402
from repro.models import build_model as rbuild  # noqa: E402
from repro.serving import Request as RRequest  # noqa: E402
from repro.serving import ServingEngine as REngine  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def models():
    rcfg = dataclasses.replace(rsmoke(rget_config("gemma-2b")), compute_dtype="float32")
    rapi = rbuild(rcfg, remat=False)
    rparams = rapi.init_params(jax.random.PRNGKey(0))
    cfg = dataclasses.replace(smoke_config(get_config("gemma-2b")), compute_dtype="float32")
    api = build_model(cfg, device="cpu")
    params = lm_params_from_jax(jax.tree.map(np.asarray, rparams), cfg)
    return rapi, rparams, api, params


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def test_param_conversion_is_exact(models):
    rapi, rparams, api, params = models
    seg = rparams["segments"][0]
    assert len(params.layers) == 4
    assert np.array_equal(params.embed.numpy(), np.asarray(rparams["embed"]))
    for i, layer in enumerate(params.layers):
        assert np.array_equal(layer["attn"]["wq"].numpy(), np.asarray(seg["attn"]["wq"][i, 0]))
        assert np.array_equal(layer["mlp"]["w_down"].numpy(),
                              np.asarray(seg["mlp"]["w_down"][i, 0]))


def test_forward_logits_match_reference(models):
    rapi, rparams, api, params = models
    toks = _tokens(api.cfg, 2, 16, 0)
    want = rapi.forward(rparams, {"tokens": jnp.asarray(toks)})
    got = api.forward(params, {"tokens": toks})
    assert got.shape == (2, 16, api.cfg.padded_vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefill_and_decode_match_reference(models):
    """Prefill's last logits and the filled cache, then 5 decode steps."""
    rapi, rparams, api, params = models
    b, s, steps, max_len = 2, 12, 5, 32
    toks = _tokens(api.cfg, b, s + steps, 1)
    rcache = rapi.init_cache(b, max_len)
    rlog, rcache = rapi.prefill(rparams, {"tokens": jnp.asarray(toks[:, :s])}, rcache)
    cache = api.init_cache(b, max_len)
    log, cache = api.prefill(params, {"tokens": toks[:, :s]}, cache)
    np.testing.assert_allclose(log.numpy(), np.asarray(rlog), **TOL)
    # reference cache: [reps, g, B, Smax, KV, hd] per segment; port: per layer
    rk = np.asarray(rcache[0]["k"])
    rv = np.asarray(rcache[0]["v"])
    for i, c in enumerate(cache):
        assert c["k"].shape == (b, max_len, api.cfg.num_kv_heads, api.cfg.head_dim)
        np.testing.assert_allclose(c["k"].numpy(), rk[i, 0], **TOL)
        np.testing.assert_allclose(c["v"].numpy(), rv[i, 0], **TOL)
    for t in range(steps):
        tok = toks[:, s + t:s + t + 1]
        rlog, rcache = rapi.decode_step(rparams, jnp.asarray(tok),
                                        jnp.asarray(s + t, jnp.int32), rcache)
        log, cache = api.decode_step(params, tok, s + t, cache)
        np.testing.assert_allclose(log.numpy(), np.asarray(rlog), **TOL)


def _requests(cls, prompts, n_new):
    return [cls(uid=i, prompt=p, max_new_tokens=n) for i, (p, n) in
            enumerate(zip(prompts, n_new))]


@pytest.mark.parametrize("scenario", ["manual", "waves", "unequal-lengths"])
def test_engine_tokens_identical_to_reference(models, scenario):
    """``tests/test_serving.py``'s two scenarios, and one wave of prompts of
    unequal lengths (left-padded with token 0, no pad mask)."""
    rapi, rparams, api, params = models
    v = api.cfg.vocab_size
    if scenario == "manual":
        rng = np.random.default_rng(0)
        prompts = [rng.integers(0, v, 8).astype(np.int32) for _ in range(3)]
        n_new, batch = [5] * 3, 3
    elif scenario == "waves":
        rng = np.random.default_rng(1)
        prompts = [rng.integers(0, v, 6).astype(np.int32) for _ in range(5)]
        n_new, batch = [3] * 5, 2
    else:
        rng = np.random.default_rng(2)
        prompts = [rng.integers(0, v, n).astype(np.int32) for n in (3, 9, 6, 1)]
        n_new, batch = [4, 2, 5, 3], 4
    want = REngine(rapi, rparams, batch_size=batch, max_len=64).serve(
        _requests(RRequest, prompts, n_new))
    got = ServingEngine(api, params, batch_size=batch, max_len=64).serve(
        _requests(Request, prompts, n_new))
    assert got == want
    assert [len(got[i]) for i in range(len(prompts))] == n_new


def _manual_greedy(api, params, prompt, n_new, max_len):
    cache = api.init_cache(1, max_len)
    logits, cache = api.prefill(params, {"tokens": prompt[None]}, cache)
    toks, cur, pos = [], int(logits[0].argmax()), prompt.shape[0]
    for _ in range(n_new):
        toks.append(cur)
        logits, cache = api.decode_step(params, torch.tensor([[cur]]), pos, cache)
        cur = int(logits[0].argmax())
        pos += 1
    return toks


def test_engine_matches_manual(models):
    """The port's copy of ``tests/test_serving.py::test_engine_matches_manual``."""
    _, _, api, params = models
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, api.cfg.vocab_size, 8).astype(np.int32) for _ in range(3)]
    results = ServingEngine(api, params, batch_size=3, max_len=64).serve(
        _requests(Request, prompts, [5] * 3))
    for i, p in enumerate(prompts):
        assert results[i] == _manual_greedy(api, params, p, 5, 64)


def test_decode_matches_forward(models):
    """The port's copy of ``tests/test_models_smoke.py::test_decode_matches_forward``
    for gemma-2b (same seed, shapes and tolerance, on the port's own draw)."""
    _, _, api, _ = models
    params = api.init_params(torch.Generator().manual_seed(1))
    b, s = 2, 12
    toks = _tokens(api.cfg, b, s + 1, 1)
    full = api.forward(params, {"tokens": toks})
    cache = api.init_cache(b, 32)
    logits_p, cache = api.prefill(params, {"tokens": toks[:, :s]}, cache)
    torch.testing.assert_close(logits_p, full[:, s - 1], rtol=2e-3, atol=2e-4)
    got, cache = api.decode_step(params, toks[:, s:], s, cache)
    torch.testing.assert_close(got, full[:, s], rtol=2e-3, atol=2e-4)


def test_later_slices_raise():
    """What the port still refuses, as the reference does: whisper through
    ``ServingEngine``.  The engine hands prefill only the tokens and the
    encoder needs frames, so both packages raise ``KeyError: 'frames'``
    (the reference's ``serving/engine.py:59`` against ``models/decode.py:107``;
    a reference fault the port copies)."""
    rcfg = dataclasses.replace(rsmoke(rget_config("whisper-medium")), compute_dtype="float32")
    cfg = dataclasses.replace(smoke_config(get_config("whisper-medium")),
                              compute_dtype="float32")
    rapi = rbuild(rcfg, remat=False)
    rparams = rapi.init_params(jax.random.PRNGKey(0))
    api = build_model(cfg, device="cpu")
    params = lm_params_from_jax(jax.tree.map(np.asarray, rparams), cfg)
    prompt = np.arange(1, 5, dtype=np.int32)
    with pytest.raises(KeyError, match="frames") as want:
        REngine(rapi, rparams, batch_size=1, max_len=16).serve([RRequest(0, prompt, 2)])
    with pytest.raises(KeyError, match="frames") as got:
        ServingEngine(api, params, batch_size=1, max_len=16).serve([Request(0, prompt, 2)])
    assert got.value.args == want.value.args == ("frames",)


def test_cuda_requested_without_gpu_raises(models, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build_model(models[2].cfg)


def test_serve_driver_runs_on_cpu():
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--smoke", "--device", "cpu",
         "--requests", "3", "--batch", "2", "--new-tokens", "2", "--max-len", "32"],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr
    assert "served 3 requests, 6 tokens" in out.stdout
