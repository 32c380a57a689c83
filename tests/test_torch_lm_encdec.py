"""Port parity, encdec (whisper-medium) and vlm (phi-3-vision-4.2b) families
at smoke widths in float32, against the JAX reference on the same
parameters (``convert.lm_params_from_jax``: the encoder stacked [L, …],
``enc_pos``, ``enc_final_norm``, ``pos_embed``, ``patch_proj`` and every
layer's ``ln_cross`` / ``cross``).

Logits, caches and the loss: rtol = atol = 2e-5, as ``test_torch_lm.py``.
Gradients: rtol 1e-4 with atol 1e-4 of the leaf's largest reference value
(measured: ≤ 1.7e-6 of it, float32 sums in another order).  Decode against
forward in the port: rtol 2e-3 / atol 2e-4 (``tests/test_models_smoke.py:71``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as rget_config  # noqa: E402
from repro.configs import smoke_config as rsmoke  # noqa: E402
from repro.data import DataConfig as RDataConfig  # noqa: E402
from repro.data import synthetic_batch as rsynthetic_batch  # noqa: E402
from repro.models import attention as rattn  # noqa: E402
from repro.models import build_model as rbuild  # noqa: E402
from repro.serving import Request as RRequest  # noqa: E402
from repro.serving import ServingEngine as REngine  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.convert import leaf_at, lm_name_map, lm_params_from_jax  # noqa: E402
from repro_torch.data import DataConfig, synthetic_batch  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.transformer import run_encoder  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)
DECODE_TOL = dict(rtol=2e-3, atol=2e-4)
ARCHS = ["whisper-medium", "phi-3-vision-4.2b"]


@pytest.fixture(scope="module")
def models():
    built = {}

    def get(arch):
        if arch not in built:
            rcfg = dataclasses.replace(rsmoke(rget_config(arch)), compute_dtype="float32")
            cfg = dataclasses.replace(smoke_config(get_config(arch)), compute_dtype="float32")
            rapi = rbuild(rcfg, remat=False)
            rparams = jax.jit(rapi.init_params)(jax.random.PRNGKey(0))
            np_params = jax.tree.map(np.asarray, rparams)
            built[arch] = (rapi, rparams, build_model(cfg, device="cpu"),
                           lm_params_from_jax(np_params, cfg), lm_name_map(np_params, cfg))
        return built[arch]
    return get


def _batch(cfg, b, s, seed, patches=True):
    """tokens [b, s] and the stub frontend's frames or patches, as numpy."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.enc_len:
        batch["frames"] = rng.standard_normal((b, cfg.enc_len, cfg.d_model)).astype(np.float32)
    if cfg.num_patches and patches:
        batch["patches"] = rng.standard_normal(
            (b, cfg.num_patches, cfg.d_model)).astype(np.float32)
    return batch


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


@pytest.mark.parametrize("arch", ARCHS)
def test_params_carried_exactly(models, arch):
    rapi, rparams, api, params, names = models(arch)
    state = params.state_dict()
    assert sorted(state) == sorted(names)
    for name, (path, idx) in names.items():
        want = np.asarray(leaf_at(rparams, path))[idx]
        assert np.array_equal(state[name].numpy(), want), name
    cfg = api.cfg
    if cfg.enc_layers:
        assert len(params.encoder) == cfg.enc_layers and "cross" in params.layers[0]
        assert params.pos_embed.shape == (36864, cfg.d_model)
        assert params.enc_pos.shape == (cfg.enc_len, cfg.d_model)
    else:
        assert params.patch_proj.shape == (cfg.d_model, cfg.d_model)
    assert not any(p.requires_grad for p in params.parameters())


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_reference(models, arch):
    rapi, rparams, api, params, _ = models(arch)
    batch = _batch(api.cfg, 2, 12, 0)
    want = jax.jit(rapi.forward)(rparams, _jnp(batch))
    got = api.forward(params, batch)
    assert got.shape == (2, 12 + api.cfg.num_patches, api.cfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_vlm_forward_text_only_matches_reference(models):
    rapi, rparams, api, params, _ = models("phi-3-vision-4.2b")
    batch = _batch(api.cfg, 2, 12, 1, patches=False)
    want = jax.jit(rapi.forward)(rparams, _jnp(batch))
    got = api.forward(params, batch)
    assert got.shape == (2, 12, api.cfg.padded_vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _cache_pairs(rcache, cache):
    """(name, reference array, port tensor): the reference's segment 0 is
    every layer, stacked [L, 1, …]."""
    seg = rcache[0]
    return [(f"layer {i}.{k}", np.asarray(seg[k][i, 0]), c[k])
            for i, c in enumerate(cache) for k in sorted(seg)]


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(models, arch):
    """Prefill (with frames or patches) and 6 decode steps: each step's
    logits and the caches, whisper's cross ``ck``/``cv`` included."""
    rapi, rparams, api, params, _ = models(arch)
    cfg = api.cfg
    batch = _batch(cfg, 2, 10, 2)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, (2, 6)).astype(np.int32)
    p = cfg.num_patches
    rcache, cache = rapi.init_cache(2, 32), api.init_cache(2, 32)
    rlog, rcache = jax.jit(rapi.prefill)(rparams, _jnp(batch), rcache)
    log, cache = api.prefill(params, batch, cache)
    np.testing.assert_allclose(log.numpy(), np.asarray(rlog), **TOL)
    rdecode = jax.jit(rapi.decode_step)
    for t in range(toks.shape[1]):
        pos = p + 10 + t
        rlog, rcache = rdecode(rparams, jnp.asarray(toks[:, t:t + 1]), jnp.asarray(pos), rcache)
        log, cache = api.decode_step(params, toks[:, t:t + 1], pos, cache)
        np.testing.assert_allclose(log.numpy(), np.asarray(rlog), err_msg=f"step {t}", **TOL)
    pairs = _cache_pairs(rcache, cache)
    assert {n.split(".")[1] for n, _, _ in pairs} == (
        {"k", "v", "ck", "cv"} if cfg.enc_layers else {"k", "v"})
    for name, want, got in pairs:
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got.numpy(), want, err_msg=name, **TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward(models, arch):
    """The reference's ``test_decode_matches_forward`` in the port: prefill's
    last logits and one decode step against teacher-forced forward."""
    _, _, api, params, _ = models(arch)
    cfg = api.cfg
    batch = _batch(cfg, 2, 12, 4)
    nxt = np.random.default_rng(5).integers(0, cfg.vocab_size, (2, 1)).astype(np.int32)
    full = api.forward(params, dict(batch, tokens=np.concatenate([batch["tokens"], nxt], 1)))
    p = cfg.num_patches
    logits, cache = api.prefill(params, batch, api.init_cache(2, 32))
    torch.testing.assert_close(logits, full[:, p + 11], **DECODE_TOL)
    got, _ = api.decode_step(params, nxt, p + 12, cache)
    torch.testing.assert_close(got, full[:, p + 12], **DECODE_TOL)


def test_whisper_cross_cache_is_the_encoders_projection(models):
    """Prefill fills each layer's ``ck``/``cv`` with the encoder output
    through that layer's cross ``wk``/``wv``."""
    _, _, api, params, _ = models("whisper-medium")
    cfg = api.cfg
    batch = _batch(cfg, 2, 5, 6)
    _, cache = api.prefill(params, batch, api.init_cache(2, 16))
    enc = run_encoder(params, torch.from_numpy(batch["frames"]), cfg)
    shape = (2, cfg.enc_len, cfg.num_kv_heads, cfg.head_dim)
    for block, c in zip(params.layers, cache):
        assert torch.equal(c["ck"], (enc @ block["cross"]["wk"]).reshape(shape))
        assert torch.equal(c["cv"], (enc @ block["cross"]["wv"]).reshape(shape))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_cross_attention_cached_matches_reference(dtype):
    """Alone, GQA 4/2 heads, the K/V cache in float32 and x in ``dtype``."""
    cfg = dataclasses.replace(smoke_config(get_config("whisper-medium")), num_kv_heads=2)
    rng = np.random.default_rng(7)
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    p = {"wq": rng.standard_normal((d, h * hd)) / np.sqrt(d),
         "wo": rng.standard_normal((h * hd, d)) / np.sqrt(h * hd)}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((2, 5, d)).astype(np.float32)
    ck, cv = (rng.standard_normal((2, 16, kv, hd)).astype(np.float32) for _ in range(2))
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = rattn.cross_attention_cached(jnp.asarray(x).astype(jdt),
                                        {k: jnp.asarray(v) for k, v in p.items()}, cfg,
                                        jnp.asarray(ck), jnp.asarray(cv))
    got = tattn.cross_attention_cached(torch.from_numpy(x).to(tdt),
                                       {k: torch.from_numpy(v) for k, v in p.items()}, cfg,
                                       torch.from_numpy(ck), torch.from_numpy(cv))
    assert got.dtype == tdt and got.shape == (2, 5, d)
    tol = TOL if dtype == "float32" else dict(rtol=2 ** -7, atol=2e-2)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), **tol)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(models, arch):
    """``loss_fn`` on ``synthetic_batch`` (phi-3-vision: patch positions
    dropped from the loss) and every gradient leaf against ``jax.grad`` of
    the reference's, through the name map."""
    rapi, rparams, api, _, names = models(arch)
    params = lm_params_from_jax(jax.tree.map(np.asarray, rparams), api.cfg, trainable=True)
    rbatch = rsynthetic_batch(rapi.cfg, RDataConfig(seq_len=12, global_batch=2), 0)
    rloss, rgrads = jax.jit(jax.value_and_grad(rapi.loss_fn))(rparams, rbatch)
    loss = api.loss_fn(params, synthetic_batch(api.cfg, DataConfig(12, 2), 0, device="cpu"))
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(rloss), rel=2e-5)
    for name, p in params.named_parameters():
        path, idx = names[name]
        want = np.asarray(leaf_at(rgrads, path))[idx]
        got = p.grad.numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max(),
                                   err_msg=name)


def test_vlm_serves_text_only_tokens_identical_to_reference(models):
    rapi, rparams, api, params, _ = models("phi-3-vision-4.2b")
    rng = np.random.default_rng(8)
    prompts = [rng.integers(0, api.cfg.vocab_size, n).astype(np.int32) for n in (5, 9, 3)]

    def reqs(cls):
        return [cls(uid=i, prompt=p, max_new_tokens=4) for i, p in enumerate(prompts)]
    want = REngine(rapi, rparams, batch_size=2, max_len=32).serve(reqs(RRequest))
    assert ServingEngine(api, params, batch_size=2, max_len=32).serve(reqs(Request)) == want


def test_serve_launcher_takes_phi3_vision(capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", "phi-3-vision-4.2b", "--smoke", "--device", "cpu", "--requests",
                "3", "--batch", "2", "--new-tokens", "2", "--max-len", "32"])
    assert "served 3 requests, 6 tokens" in capsys.readouterr().out
