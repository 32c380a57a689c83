"""Port parity, LM families: local-window attention (gemma2-27b, gemma3-4b,
mixtral's sliding window), mixture of experts (mixtral-8x7b,
moonshot-v1-16b-a3b), SSM (mamba2-1.3b) and hybrid (zamba2-1.2b), at smoke
widths in float32, against the JAX reference on the same parameters.

The reference's ``init_params(PRNGKey(0))`` is carried into the port by
``convert.lm_params_from_jax``.  Logits and caches: rtol = atol = 2e-5, as
``test_torch_lm.py``; the port's windowed decode against its full-cache
decode: rtol 2e-4 / atol 2e-5 (``tests/test_windowed_cache.py``).  MoE
dispatch slots and token ids must be array-equal to the reference's,
served tokens identical.
"""
import dataclasses
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as rget_config  # noqa: E402
from repro.configs import smoke_config as rsmoke  # noqa: E402
from repro.models import build_model as rbuild  # noqa: E402
from repro.models import moe as rmoe  # noqa: E402
from repro.models import ssm as rssm  # noqa: E402
from repro.serving import Request as RRequest  # noqa: E402
from repro.serving import ServingEngine as REngine  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.convert import lm_params_from_jax  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from repro_torch.serving import Request, ServingEngine  # noqa: E402

TOL = dict(rtol=2e-5, atol=2e-5)
ARCHS = ["gemma2-27b", "gemma3-4b", "mixtral-8x7b", "moonshot-v1-16b-a3b",
         "mamba2-1.3b", "zamba2-1.2b"]
WINDOWED = ["gemma2-27b", "gemma3-4b", "mixtral-8x7b"]


def _cfgs(arch, window=None):
    """(reference cfg, port cfg) at smoke widths in float32; ``window``
    replaces every local window (so that a rolling buffer wraps)."""
    out = []
    for get, smoke in ((rget_config, rsmoke), (get_config, smoke_config)):
        cfg = dataclasses.replace(smoke(get(arch)), compute_dtype="float32")
        if window:
            cfg = dataclasses.replace(cfg, layer_pattern=tuple(
                window if w > 0 else w for w in cfg.layer_pattern))
        out.append(cfg)
    return out


@pytest.fixture(scope="module")
def models():
    """(arch, window) → (reference api, reference params, port api, port params)."""
    built = {}

    def get(arch, window=None):
        if (arch, window) not in built:
            rcfg, cfg = _cfgs(arch, window)
            rapi = rbuild(rcfg, remat=False)
            rparams = jax.jit(rapi.init_params)(jax.random.PRNGKey(0))
            params = lm_params_from_jax(jax.tree.map(np.asarray, rparams), cfg)
            built[arch, window] = (rapi, rparams, build_model(cfg, device="cpu"), params)
        return built[arch, window]
    return get


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (b, s)).astype(np.int32)


def _reference_layers(rparams, cfg):
    """The reference's per-layer parameter leaves, in the port's layer order:
    [(layer index, dotted name, array)]."""
    from repro_torch.models.common import find_segments

    out, i = [], 0
    for seg, (group, reps) in zip(rparams["segments"], find_segments(cfg.layer_pattern)):
        leaves = jax.tree_util.tree_leaves_with_path(seg)
        for rep in range(reps):
            for j in range(len(group)):
                for path, leaf in leaves:
                    name = ".".join(str(p.key) for p in path)
                    out.append((i, name, np.asarray(leaf)[rep, j]))
                i += 1
    return out


@pytest.mark.parametrize("arch", ARCHS)
def test_params_carried_exactly(models, arch):
    """Every reference tensor, stacked [reps, g, …] segments, expert tensors
    [E, D, F], mamba layers and zamba2's ``shared_attn``, array-equal."""
    rapi, rparams, api, params = models(arch)
    state = params.state_dict()
    n = 0
    for i, name, want in _reference_layers(rparams, api.cfg):
        got = state.pop(f"layers.{i}.{name}").numpy()
        assert got.shape == want.shape and np.array_equal(got, want), (i, name)
        n += 1
    for path, leaf in jax.tree_util.tree_leaves_with_path(
            {k: v for k, v in rparams.items() if k != "segments"}):
        name = ".".join(str(p.key) for p in path)
        assert np.array_equal(state.pop(name).numpy(), np.asarray(leaf)), name
    assert not state, sorted(state)
    if api.cfg.num_experts:
        assert params.layers[0]["moe"]["w_gate"].shape == (
            api.cfg.num_experts, api.cfg.d_model, api.cfg.d_ff)
    if api.cfg.shared_attn_every:
        assert "shared_attn.attn.wq" in params.state_dict()
    assert n > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_logits_match_reference(models, arch):
    rapi, rparams, api, params = models(arch)
    toks = _tokens(api.cfg, 2, 16, 0)
    want = jax.jit(rapi.forward)(rparams, {"tokens": jnp.asarray(toks)})
    got = api.forward(params, {"tokens": toks})
    assert got.shape == (2, 16, api.cfg.padded_vocab) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def _cache_pairs(rcache, cache, cfg):
    """(name, reference array, port tensor) for every cache entry, the
    reference's stacked layout unstacked into the port's per-layer one."""
    from repro_torch.models.common import find_segments

    if isinstance(rcache, dict):      # ssm / hybrid
        pairs = []
        for key in ("conv", "ssd"):
            pairs += [(f"mamba.{i}.{key}", np.asarray(rcache["mamba"][key][i]), c[key])
                      for i, c in enumerate(cache["mamba"])]
        for key in ("k", "v"):
            pairs += [(f"shared.{i}.{key}", np.asarray(rcache["shared"][key][i]), c[key])
                      for i, c in enumerate(cache.get("shared", []))]
        return pairs
    pairs, i = [], 0
    for seg, (group, reps) in zip(rcache, find_segments(cfg.layer_pattern)):
        for rep in range(reps):
            for j in range(len(group)):
                for key in ("k", "v"):
                    want = seg[f"{key}_{j}"][rep] if f"{key}_0" in seg else seg[key][rep, j]
                    pairs.append((f"layer {i}.{key}", np.asarray(want), cache[i][key]))
                i += 1
    return pairs


def _run_cached(rapi, rparams, api, params, toks, s, max_len, window_cache=False):
    """Prefill toks[:, :s], then decode the rest, in both packages; returns
    the per-step logits and the final caches."""
    b = toks.shape[0]
    rcache = rapi.init_cache(b, max_len, window_cache=window_cache)
    cache = api.init_cache(b, max_len, window_cache=window_cache)
    assert _nbytes(cache) == sum(x.nbytes for x in jax.tree.leaves(rcache))
    rdecode = jax.jit(rapi.decode_step)
    rlog, rcache = jax.jit(rapi.prefill)(rparams, {"tokens": jnp.asarray(toks[:, :s])},
                                         rcache)
    log, cache = api.prefill(params, {"tokens": toks[:, :s]}, cache)
    logs = [(np.asarray(rlog), log.numpy())]
    for t in range(s, toks.shape[1]):
        tok = toks[:, t:t + 1]
        rlog, rcache = rdecode(rparams, jnp.asarray(tok), jnp.asarray(t, jnp.int32), rcache)
        log, cache = api.decode_step(params, tok, t, cache)
        logs.append((np.asarray(rlog), log.numpy()))
    return logs, rcache, cache


def _nbytes(cache):
    if isinstance(cache, dict):
        return sum(_nbytes(v) for v in cache.values())
    if isinstance(cache, list):
        return sum(_nbytes(v) for v in cache)
    return cache.numel() * cache.element_size()


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(models, arch):
    """Prefill's last logits, then 6 decode steps; the caches (sized as the
    reference's, byte for byte) after the last step."""
    rapi, rparams, api, params = models(arch)
    toks = _tokens(api.cfg, 2, 18, 1)
    logs, rcache, cache = _run_cached(rapi, rparams, api, params, toks, 12, 32)
    for t, (want, got) in enumerate(logs):
        np.testing.assert_allclose(got, want, err_msg=f"step {t}", **TOL)
    pairs = _cache_pairs(rcache, cache, api.cfg)
    assert pairs
    for name, want, got in pairs:
        assert got.shape == want.shape and got.dtype == torch.float32, name
        np.testing.assert_allclose(got.numpy(), want, err_msg=name, **TOL)


@pytest.mark.parametrize("arch", WINDOWED)
def test_windowed_cache_matches_reference(models, arch):
    """``window_cache=True`` with windows of 4 (the buffer wraps): logits and
    rolling buffers equal the reference's, the buffers are smaller than the
    full cache, and the port's windowed decode equals its full-cache one."""
    rapi, rparams, api, params = models(arch, window=4)
    toks = _tokens(api.cfg, 2, 18, 0)
    logs, rcache, cache = _run_cached(rapi, rparams, api, params, toks, 10, 32,
                                      window_cache=True)
    for t, (want, got) in enumerate(logs):
        np.testing.assert_allclose(got, want, err_msg=f"step {t}", **TOL)
    for name, want, got in _cache_pairs(rcache, cache, api.cfg):
        assert got.shape == want.shape, name
        np.testing.assert_allclose(got.numpy(), want, err_msg=name, **TOL)
    assert [c["k"].shape[1] for c in cache] == [4 if w else 32 for w in api.cfg.layer_pattern]
    assert _nbytes(cache) < _nbytes(api.init_cache(2, 32))
    full = api.init_cache(2, 32)
    log, full = api.prefill(params, {"tokens": toks[:, :10]}, full)
    np.testing.assert_allclose(log.numpy(), logs[0][1], rtol=2e-4, atol=2e-5)
    for t in range(10, 18):
        log, full = api.decode_step(params, toks[:, t:t + 1], t, full)
        np.testing.assert_allclose(log.numpy(), logs[t - 9][1], rtol=2e-4, atol=2e-5,
                                   err_msg=f"step {t}")


# ---------------------------------------------------------------------------
# MoE dispatch
# ---------------------------------------------------------------------------
def _recording_jax(monkeypatch):
    """Swap ``repro.models.moe``'s ``jax`` for a proxy whose ``vmap`` records
    what each vmapped function returns: the first call is ``dispatch_row``,
    whose second output is the reference's (slot, token, gate) COO."""
    calls = []

    def vmap(fn, *a, **kw):
        mapped = jax.vmap(fn, *a, **kw)

        def run(*args):
            out = mapped(*args)
            calls.append(out)
            return out
        return run

    proxy = types.SimpleNamespace(**{n: getattr(jax, n) for n in ("nn", "lax", "Array")},
                                  vmap=vmap)
    monkeypatch.setattr(rmoe, "jax", proxy)
    return calls


def _moe_case(cap_factor, x=None, router=None, seed=0):
    rcfg, cfg = _cfgs("mixtral-8x7b")
    rcfg = dataclasses.replace(rcfg, moe_capacity_factor=cap_factor)
    cfg = dataclasses.replace(cfg, moe_capacity_factor=cap_factor)
    rp = rmoe.init_moe(jax.random.PRNGKey(seed), rcfg)
    if router is not None:
        rp = dict(rp, router=jnp.asarray(router))
    p = {k: torch.from_numpy(np.array(v)) for k, v in rp.items()}
    if x is None:
        x = np.random.default_rng(seed).standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    return rcfg, cfg, rp, p, x


def _port_dispatch(x, p, cfg):
    cap = tmoe._capacity(x.shape[1], cfg, cfg.moe_capacity_factor)
    top_val, top_idx = tmoe.route(torch.from_numpy(x), p["router"], cfg)
    return cap, top_idx, tmoe.dispatch(top_idx, top_val, cap, cfg.num_experts, torch.float32)


@pytest.mark.parametrize("cap_factor", [8.0, 0.5])
def test_moe_dispatch_and_output_match_reference(monkeypatch, cap_factor):
    """At capacity factor 8 (dropless) and 0.5 (tokens dropped): slots and
    token ids array-equal, gates and output within 2e-5."""
    rcfg, cfg, rp, p, x = _moe_case(cap_factor)
    calls = _recording_jax(monkeypatch)
    want = np.asarray(rmoe.moe_ffn(jnp.asarray(x), rp, rcfg))
    rslot, rts, rgs = (np.asarray(a) for a in calls[0][1])
    cap, _, (slot, ts, gs) = _port_dispatch(x, p, cfg)
    assert np.array_equal(slot.numpy(), rslot) and np.array_equal(ts.numpy(), rts)
    np.testing.assert_allclose(gs.numpy(), rgs, **TOL)
    dropped = int((slot == cfg.num_experts * cap).sum())
    assert (dropped > 0) == (cap_factor < 1), dropped
    got = tmoe.moe_ffn(torch.from_numpy(x), p, cfg)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_moe_gate_tie_breaks_to_lower_expert(monkeypatch):
    """Two router columns equal (a gate tie between experts 1 and 2) and
    repeated tokens (equal ranks decided by token order): top-k takes expert
    1 before 2, as ``jax.lax.top_k``, and the capacity drops the later
    copies, slots array-equal to the reference's."""
    rcfg, cfg = _cfgs("mixtral-8x7b")
    router = np.array(rmoe.init_moe(jax.random.PRNGKey(0), rcfg)["router"])
    router[:, 2] = router[:, 1]
    # tokens along expert 1's column: experts 1 and 2 tie and win
    x = np.repeat(10 * router[None, None, :, 1], 12, axis=1)
    x[0, ::3] *= 2.0
    rcfg, cfg, rp, p, x = _moe_case(0.5, x=x, router=router)
    gates = jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router), axis=-1)
    rval, ridx = jax.lax.top_k(gates, 2)
    val, idx = tmoe.route(torch.from_numpy(x), p["router"], cfg)
    assert np.array_equal(idx.numpy(), np.asarray(ridx))
    assert (idx.numpy()[..., 0] == 1).all() and (idx.numpy()[..., 1] == 2).all()
    calls = _recording_jax(monkeypatch)
    want = np.asarray(rmoe.moe_ffn(jnp.asarray(x), rp, rcfg))
    cap, _, (slot, ts, _) = _port_dispatch(x, p, cfg)
    assert np.array_equal(slot.numpy(), np.asarray(calls[0][1][0]))
    assert int((slot == cfg.num_experts * cap).sum()) > 0
    np.testing.assert_allclose(tmoe.moe_ffn(torch.from_numpy(x), p, cfg).numpy(), want, **TOL)


def test_capacity_and_router_aux_loss_match_reference():
    rcfg, cfg, rp, p, _ = _moe_case(1.25)
    for tokens in (1, 2, 7, 16, 100, 1024):
        for cf in (0.25, 0.5, 1.0, 1.25, 8.0):
            assert tmoe._capacity(tokens, cfg, cf) == rmoe._capacity(tokens, rcfg, cf)
    x = np.random.default_rng(0).standard_normal((2, 32, cfg.d_model)).astype(np.float32)
    want = float(rmoe.router_aux_loss(jnp.asarray(x), rp, rcfg))
    got = float(tmoe.router_aux_loss(torch.from_numpy(x), p, cfg))
    assert got == pytest.approx(want, rel=1e-6) and got >= 1.0 - 1e-3


# ---------------------------------------------------------------------------
# SSD
# ---------------------------------------------------------------------------
def _naive_ssd(x, dt, A, B, C):
    """state_t = state·exp(dt_t A) + dt_t x_t ⊗ B_t;  y_t = C_t·state_t
    (``tests/test_ssd.py``'s loop, in float64)."""
    b, s, h, p = x.shape
    hpg = h // B.shape[-2]
    state = np.zeros((b, h, p, B.shape[-1]))
    ys = np.zeros(x.shape)
    for t in range(s):
        decay = np.exp(dt[:, t] * A[None, :])
        Bh = np.repeat(B[:, t], hpg, axis=1)
        Ch = np.repeat(C[:, t], hpg, axis=1)
        state = state * decay[..., None, None] + \
            (dt[:, t][..., None] * x[:, t])[..., None] * Bh[:, :, None, :]
        ys[:, t] = np.einsum("bhpn,bhn->bhp", state, Ch)
    return ys, state


@pytest.mark.parametrize("s,chunk", [(8, 4), (32, 8), (12, 12), (48, 16)])
def test_ssd_chunked_matches_reference_and_naive_scan(s, chunk):
    rng = np.random.default_rng(s)
    b, h, p, n = 2, 4, 8, 16
    x = rng.standard_normal((b, s, h, p)).astype(np.float32)
    dt = rng.random((b, s, h)).astype(np.float32) * 0.5
    A = -rng.random(h).astype(np.float32)
    B = rng.standard_normal((b, s, 1, n)).astype(np.float32)
    C = rng.standard_normal((b, s, 1, n)).astype(np.float32)
    ry, rfinal = jax.jit(rssm.ssd_chunked, static_argnums=5)(
        *(jnp.asarray(a) for a in (x, dt, A, B, C)), chunk)
    y, final = tssm.ssd_chunked(*(torch.from_numpy(a) for a in (x, dt, A, B, C)), chunk)
    np.testing.assert_allclose(y.numpy(), np.asarray(ry), **TOL)
    np.testing.assert_allclose(final.numpy(), np.asarray(rfinal), **TOL)
    ny, nfinal = _naive_ssd(x, dt, A, B, C)
    np.testing.assert_allclose(y.numpy(), ny, rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(final.numpy(), nfinal, rtol=2e-4, atol=2e-4)


def test_segment_sums_stable_where_the_reference_cancels():
    """A chunk of 256 whose decays sum to about −200, as mamba2's do at its
    initial values: the port sums each segment directly (``_segsum`` and
    ``ssd_chunked``'s chunk decays), within 1e-6 of float64 after ``exp``;
    the reference's differences of cumulative sums lose ~1e-5 there (a
    reference fault the port does not copy, ROADMAP queue 3)."""
    dA = -np.random.default_rng(0).random((2, 4, 256)).astype(np.float32) * 1.6
    cs = np.cumsum(dA.astype(np.float64), -1)
    tril = np.tril(np.ones((256, 256), bool))
    want = np.exp(cs[..., :, None] - cs[..., None, :])[..., tril]
    port = np.exp(tssm._segsum(torch.from_numpy(dA)).double().numpy())[..., tril]
    ref = np.exp(np.asarray(rssm._segsum(jnp.asarray(dA)), np.float64))[..., tril]
    assert np.abs(port - want).max() < 1e-6 < np.abs(ref - want).max()


def test_ssd_prompt_length_refusal_copied_from_reference(models):
    """A prompt longer than 256 tokens and not a multiple of 256 fails in the
    reference's ``ssd_chunked`` reshape; the port raises the same TypeError."""
    rapi, rparams, api, params = models("mamba2-1.3b")
    toks = _tokens(api.cfg, 1, 300, 2)
    with pytest.raises(TypeError, match="reshape"):
        rapi.forward(rparams, {"tokens": jnp.asarray(toks)})
    with pytest.raises(TypeError, match="whole number of chunks of 256"):
        api.forward(params, {"tokens": toks})
    with pytest.raises(TypeError):
        api.prefill(params, {"tokens": toks}, api.init_cache(1, 320))


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_tokens_identical_to_reference(models, arch):
    """Two waves of prompts of unequal lengths (left-padded with token 0, no
    pad mask: the SSM state absorbs the pads, in both packages)."""
    rapi, rparams, api, params = models(arch)
    rng = np.random.default_rng(2)
    prompts = [rng.integers(0, api.cfg.vocab_size, n).astype(np.int32)
               for n in (5, 9, 3, 7, 6)]
    n_new = [4, 2, 5, 3, 4]

    def reqs(cls):
        return [cls(uid=i, prompt=p, max_new_tokens=n)
                for i, (p, n) in enumerate(zip(prompts, n_new))]
    want = REngine(rapi, rparams, batch_size=3, max_len=32).serve(reqs(RRequest))
    got = ServingEngine(api, params, batch_size=3, max_len=32).serve(reqs(Request))
    assert got == want
    assert [len(got[i]) for i in range(len(prompts))] == n_new


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_launcher_serves_every_family(arch, capsys):
    """``launch/serve.py --arch <family> --smoke --device cpu`` runs, with no
    new flag, for every family this slice brings."""
    from repro_torch.launch import serve

    serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--requests", "3",
                "--batch", "2", "--new-tokens", "2", "--max-len", "32"])
    assert "served 3 requests, 6 tokens" in capsys.readouterr().out
