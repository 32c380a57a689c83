"""Port parity, training slice: the data pipeline, the schedule, AdamW, the
error-feedback quantizer and ``make_train_step`` against the JAX reference.

- ``synthetic_batch``: array-equal to the reference's for every arch's smoke
  config (the same numpy draws in the same order).
- ``schedule``: rtol 1e-6 (float32 ``cos`` in two libraries).
- ``adamw_update`` on the same gradients: rtol 1e-6 / atol 1e-9 (float32
  ``pow`` and ``sqrt`` in two libraries).
- The quantizer on the same gradients: array-equal.
- ``make_train_step`` (gemma-2b's smoke widths cut to 2 global layers,
  float32): each of two steps runs from the reference's state carried into
  the port, so a step is held to the reference's same step.  Loss,
  gradient norm and lr rtol 1e-5; μ and ν rtol 1e-4 (of the larger of
  their two terms, b·m₀ and the new value) with atol 1e-8 and 1e-10; residuals rtol 1e-4 / atol 1e-6 (the gradients agree to ~3e-7
  at most, float32 sums in another order); parameters rtol 2e-4 / atol 2e-5
  (``tests/test_train.py:57``).
  Two kinds of element may leave the tolerance, held to a bound instead
  and counted (a few in 10^4):
  * parameters where √v̂ < 1e-6 (100·ε): there Adam's direction
    m̂/(√v̂+ε) is ill-conditioned (at |g| ~ ε a relative gradient error of
    1e-3, or a sign, moves it by up to 2); |Δp| ≤ 2.5·lr;
  * with compression, where g + r lies within the gradients' error of a
    2^-f grid point, the truncation may fall either side: there the two
    residuals differ by exactly one grid step (q + r, which is continuous,
    agrees), μ, ν and p are held to the bound above, and the gradient
    norm (of q) to ‖q − q'‖.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as rget_config  # noqa: E402
from repro.configs import list_archs  # noqa: E402
from repro.configs import smoke_config as rsmoke  # noqa: E402
from repro.core import quantization as rquant  # noqa: E402
from repro.data import DataConfig as RDataConfig  # noqa: E402
from repro.data import synthetic_batch as rsynthetic_batch  # noqa: E402
from repro.models import build_model as rbuild  # noqa: E402
from repro.training import AdamWConfig as RAdamWConfig  # noqa: E402
from repro.training import init_train_state as rinit_train_state  # noqa: E402
from repro.training import make_train_step as rmake_train_step  # noqa: E402
from repro.training import optimizer as roptim  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.convert import leaf_at, lm_name_map, lm_params_from_jax  # noqa: E402
from repro_torch.core.quantization import ErrorFeedbackQuantizer  # noqa: E402
from repro_torch.data import DataConfig, data_iterator, synthetic_batch  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.training import (  # noqa: E402
    AdamWConfig,
    TrainState,
    init_train_state,
    make_train_step,
)
from repro_torch.training import optimizer as toptim  # noqa: E402

OPT = dict(lr=1e-2, warmup_steps=1, total_steps=10)
TWO_LAYERS = dict(compute_dtype="float32", num_layers=2, layer_pattern=(0, 0))
ILL = 1e-6          # √v̂ below this: Adam's direction is ill-conditioned


def _cfgs(arch, **kw):
    return (dataclasses.replace(rsmoke(rget_config(arch)), **kw),
            dataclasses.replace(smoke_config(get_config(arch)), **kw))


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("arch", list_archs())
def test_synthetic_batch_array_equal_to_reference(arch):
    rcfg, cfg = _cfgs(arch)
    for step in (0, 7):
        want = rsynthetic_batch(rcfg, RDataConfig(seq_len=16, global_batch=3, seed=5), step)
        got = synthetic_batch(cfg, DataConfig(seq_len=16, global_batch=3, seed=5), step,
                              device="cpu")
        assert sorted(got) == sorted(want)
        assert ("frames" in got) == bool(cfg.enc_len)
        assert ("patches" in got) == bool(cfg.num_patches)
        for k, w in want.items():
            w = np.asarray(w)
            assert got[k].numpy().dtype == w.dtype and np.array_equal(got[k].numpy(), w), k


def test_data_iterator_replays_its_steps():
    _, cfg = _cfgs("whisper-medium")
    dcfg = DataConfig(seq_len=8, global_batch=2)
    it = data_iterator(cfg, dcfg, start_step=5, device="cpu")
    for step in (5, 6):
        got, want = next(it), synthetic_batch(cfg, dcfg, step, device="cpu")
        assert all(torch.equal(got[k], want[k]) for k in want)


# ---------------------------------------------------------------------------
# schedule, AdamW, quantizer
# ---------------------------------------------------------------------------
def test_schedule_matches_reference():
    for kw in (dict(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1), OPT):
        rcfg, cfg = RAdamWConfig(**kw), AdamWConfig(**kw)
        for s in (0, 5, 10, 50, 100):
            want = float(roptim.schedule(rcfg, jnp.asarray(s)))
            got = toptim.schedule(cfg, torch.tensor(s))
            assert got.dtype == torch.float32
            assert float(got) == pytest.approx(want, rel=1e-6, abs=1e-12), (kw, s)
    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100, min_lr_ratio=0.1)
    lrs = [float(toptim.schedule(cfg, s)) for s in (0, 5, 10, 50, 100)]
    assert lrs[0] == 0.0 and abs(lrs[2] - 1.0) < 1e-6 and lrs[3] < lrs[2]
    assert abs(lrs[4] - 0.1) < 1e-6


def test_adamw_update_matches_reference_on_a_random_tree():
    """Three updates of a random tree on the same gradients (|g| ≥ 1e-3, so
    no direction is ill-conditioned), with clipping active on the first."""
    rng = np.random.default_rng(0)
    shapes = {"a": (3, 4), "b": (5,), "c": (2, 3, 2)}
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: (np.sign(x) * (1e-3 + np.abs(x)) * sc).astype(np.float32)
              for k, x in ((k, rng.standard_normal(s)) for k, s in shapes.items())}
             for sc in (3.0, 0.1, 0.05)]
    kw = dict(lr=0.05, warmup_steps=2, total_steps=20, weight_decay=0.1, clip_norm=1.0)
    rparams = {k: jnp.asarray(v) for k, v in p0.items()}
    rstate = roptim.init_opt_state(rparams)
    params = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    state = toptim.init_opt_state(params)
    for g in grads:
        rparams, rstate, rm = roptim.adamw_update(RAdamWConfig(**kw),
                                                  {k: jnp.asarray(v) for k, v in g.items()},
                                                  rstate, rparams)
        params, state, m = toptim.adamw_update(AdamWConfig(**kw),
                                               {k: torch.from_numpy(v) for k, v in g.items()},
                                               state, params)
        assert int(state.step) == int(rstate.step)
        for name in ("grad_norm", "lr"):
            assert float(m[name]) == pytest.approx(float(rm[name]), rel=1e-6)
        for got, want in ((params, rparams), (state.mu, rstate.mu), (state.nu, rstate.nu)):
            for k in shapes:
                np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                           rtol=1e-6, atol=1e-9, err_msg=k)


def test_adamw_on_quadratic():
    """The reference's ``test_adamw_on_quadratic`` in the port: AdamW drives
    a quadratic to its optimum; the trajectory's end equals the
    reference's within 1e-5."""
    kw = dict(lr=0.05, warmup_steps=1, total_steps=500, weight_decay=0.0, clip_norm=100.0)
    target = torch.tensor([1.0, -2.0, 3.0])
    params = {"w": torch.zeros(3, requires_grad=True)}
    state = toptim.init_opt_state(params)
    for _ in range(300):
        params["w"].grad = None
        torch.sum((params["w"] - target) ** 2).backward()
        params, state, _ = toptim.adamw_update(AdamWConfig(**kw), {"w": params["w"].grad},
                                               state, params)
    np.testing.assert_allclose(params["w"].detach().numpy(), target.numpy(), atol=1e-2)

    rtarget = jnp.asarray([1.0, -2.0, 3.0])
    rparams, rstate = {"w": jnp.zeros(3)}, roptim.init_opt_state({"w": jnp.zeros(3)})

    @jax.jit
    def rstep(p, s):
        g = jax.grad(lambda q: jnp.sum((q["w"] - rtarget) ** 2))(p)
        return roptim.adamw_update(RAdamWConfig(**kw), g, s, p)

    for _ in range(300):
        rparams, rstate, _ = rstep(rparams, rstate)
    np.testing.assert_allclose(params["w"].detach().numpy(), np.asarray(rparams["w"]),
                               atol=1e-5)


def test_error_feedback_quantizer_matches_reference():
    rng = np.random.default_rng(1)
    g = [{k: (rng.standard_normal(s) * 0.01).astype(np.float32)
          for k, s in (("a", (64,)), ("b", (8, 8)))} for _ in range(3)]
    rq, q = rquant.ErrorFeedbackQuantizer(frac_bits=8), ErrorFeedbackQuantizer(frac_bits=8)
    rres = rq.init_state({k: jnp.asarray(v) for k, v in g[0].items()})
    res = q.init_state({k: torch.from_numpy(v) for k, v in g[0].items()})
    for gi in g:
        rout, rres = rq.compress({k: jnp.asarray(v) for k, v in gi.items()}, rres)
        out, res = q.compress({k: torch.from_numpy(v) for k, v in gi.items()}, res)
        for k in gi:
            assert np.array_equal(out[k].numpy(), np.asarray(rout[k]))
            assert np.array_equal(res[k].numpy(), np.asarray(rres[k]))
            assert float(res[k].abs().max()) < 2.0 ** -8
    assert any(float(v.abs().max()) > 0 for v in out.values())


# ---------------------------------------------------------------------------
# the train step
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def two_layers():
    rcfg, cfg = _cfgs("gemma-2b", **TWO_LAYERS)
    rapi = rbuild(rcfg, remat=False)
    rparams = rapi.init_params(jax.random.PRNGKey(0))
    names = lm_name_map(jax.tree.map(np.asarray, rparams), cfg)
    return rcfg, cfg, rapi, rparams, names


def _port_tree(rtree, names):
    return {n: torch.from_numpy(np.array(np.asarray(leaf_at(rtree, path))[idx]))
            for n, (path, idx) in names.items()}


def _carry(rstate, cfg, names) -> TrainState:
    """The reference's TrainState as the port's (parameters trainable)."""
    params = lm_params_from_jax(jax.tree.map(np.asarray, rstate.params), cfg, trainable=True)
    opt = toptim.AdamState(step=torch.tensor(int(rstate.opt.step), dtype=torch.int32),
                           mu=_port_tree(rstate.opt.mu, names),
                           nu=_port_tree(rstate.opt.nu, names))
    res = None if rstate.residual is None else _port_tree(rstate.residual, names)
    return TrainState(params, opt, res)


def hold_step(got: TrainState, want, before, names, opt: AdamWConfig, bits: int):
    """``got`` (the port's state after a step) against ``want`` (the
    reference's), both from ``before``, as the module docstring sets out
    (μ = b1·μ₀ + (1−b1)·g may cancel: its tolerance is relative to the
    larger of its two terms); returns the counts of
    parameters outside the tolerance where Adam is ill-conditioned
    (``ill``) and of grid-straddling elements (``straddle``)."""
    step = int(want.opt.step)
    assert int(got.opt.step) == step
    lr = float(toptim.schedule(opt, step))
    b2c = 1 - opt.b2 ** step
    counts = dict(ill=0, straddle=0, elements=0)
    params = dict(got.params.named_parameters())
    for n, (path, idx) in names.items():
        p = params[n].detach().numpy()
        wp = np.asarray(leaf_at(want.params, path))[idx]
        wnu = np.asarray(leaf_at(want.opt.nu, path))[idx]
        straddle = np.zeros(p.shape, bool)
        if bits:
            r = got.residual[n].numpy()
            wr = np.asarray(leaf_at(want.residual, path))[idx]
            straddle = np.abs(r - wr) > 2.0 ** -(bits + 1)
            np.testing.assert_allclose(np.abs(r - wr)[straddle], 2.0 ** -bits, atol=1e-6,
                                       err_msg=f"{n}: residuals apart by other than a step")
            np.testing.assert_allclose(r[~straddle], wr[~straddle], rtol=1e-4, atol=1e-6,
                                       err_msg=f"{n}: residual")
            assert np.abs(r).max() <= 2.0 ** -bits
            counts["straddle"] += int(straddle.sum())
        for mine, theirs, first, b, atol in (
                (got.opt.mu, want.opt.mu, before.opt.mu, opt.b1, 1e-8),
                (got.opt.nu, want.opt.nu, before.opt.nu, opt.b2, 1e-10)):
            w = np.asarray(leaf_at(theirs, path))[idx]
            scale = np.maximum(np.abs(w), b * np.abs(np.asarray(leaf_at(first, path))[idx]))
            err = np.abs(mine[n].numpy() - w)
            assert (err <= 1e-4 * scale + atol)[~straddle].all(), (n, err.max())
        off = ~np.isclose(p, wp, rtol=2e-4, atol=2e-5)
        ill = np.sqrt(wnu / b2c) < ILL
        assert not (off & ~ill & ~straddle).any(), f"{n}: params"
        assert (np.abs(p - wp)[off] <= 2.5 * lr).all(), n
        counts["ill"] += int((off & ill).sum())
        counts["elements"] += p.size
    return counts


@pytest.mark.parametrize("microbatches,bits", [(1, 0), (2, 0), (1, 8), (2, 8)])
def test_train_step_matches_reference(two_layers, microbatches, bits):
    """Two steps of batch 4 × 16 tokens from ``synthetic_batch``; before
    each, the reference's state is carried into the port."""
    rcfg, cfg, rapi, rparams, names = two_layers
    rstep = jax.jit(rmake_train_step(rapi.loss_fn, RAdamWConfig(**OPT),
                                     microbatches=microbatches, grad_compress_bits=bits))
    api = build_model(cfg, device="cpu", remat=False)
    step = make_train_step(api.loss_fn, AdamWConfig(**OPT), microbatches=microbatches,
                           grad_compress_bits=bits)
    rstate = rinit_train_state(rparams, compress=bits > 0)
    total = dict(ill=0, straddle=0, elements=0)
    for s in range(2):
        state, before = _carry(rstate, cfg, names), rstate
        rstate, rm = rstep(rstate, rsynthetic_batch(rcfg, RDataConfig(16, 4), s))
        state, m = step(state, synthetic_batch(cfg, DataConfig(16, 4), s, device="cpu"))
        for k in ("loss", "lr"):
            assert float(m[k]) == pytest.approx(float(rm[k]), rel=1e-5), (s, k)
        counts = hold_step(state, rstate, before, names, AdamWConfig(**OPT), bits)
        # the norm of the truncated gradients moves by at most ‖q − q'‖
        assert abs(float(m["grad_norm"]) - float(rm["grad_norm"])) <= (
            1e-5 * float(rm["grad_norm"]) + 2.0 ** -bits * counts["straddle"] ** 0.5)
        for k, v in counts.items():
            total[k] += v
    # the loose elements are a few in 10^4
    assert total["ill"] + total["straddle"] < 1e-4 * total["elements"], total


@pytest.mark.parametrize("arch", ["gemma-2b", "whisper-medium", "zamba2-1.2b"])
def test_remat_equals_no_remat(arch):
    """Each layer recomputed in the backward pass (the decoder's, whisper's
    encoder's, zamba2's mamba layers) gives the same loss and gradients,
    bit for bit on the CPU."""
    _, cfg = _cfgs(arch, compute_dtype="float32")
    batch = synthetic_batch(cfg, DataConfig(16, 2), 0, device="cpu")
    grads = []
    for remat in (True, False):
        api = build_model(cfg, device="cpu", remat=remat)
        params = api.init_params(torch.Generator().manual_seed(0)).requires_grad_(True)
        loss = api.loss_fn(params, batch)
        loss.backward()
        grads.append((loss.detach(), {n: p.grad for n, p in params.named_parameters()}))
    assert torch.equal(grads[0][0], grads[1][0])
    assert all(torch.equal(g, grads[1][1][n]) for n, g in grads[0][1].items())


def test_microbatching_equals_full_batch(two_layers):
    """The reference's ``test_microbatching_equals_full_batch`` in the port:
    m = 2 against one batch, one step, parameters as ``hold_step``."""
    rcfg, cfg, rapi, rparams, names = two_layers
    api = build_model(cfg, device="cpu", remat=False)
    batch = synthetic_batch(cfg, DataConfig(8, 4), 0, device="cpu")
    out = []
    for m in (1, 2):
        params = lm_params_from_jax(jax.tree.map(np.asarray, rparams), cfg)
        state, _ = make_train_step(api.loss_fn, AdamWConfig(**OPT), microbatches=m)(
            init_train_state(params), batch)
        out.append(state)
    b2c = 1 - 0.95
    lr = float(toptim.schedule(AdamWConfig(**OPT), 1))
    for n, p in out[0].params.named_parameters():
        q = dict(out[1].params.named_parameters())[n]
        loose = torch.sqrt(out[0].opt.nu[n] / b2c) < ILL
        torch.testing.assert_close(p.detach()[~loose], q.detach()[~loose], rtol=2e-4,
                                   atol=2e-5)
        assert ((p - q).abs()[loose] <= 2.5 * lr).all()


def test_compressed_training_converges():
    """The reference's ``test_compressed_training_converges`` in the port:
    fixed-point gradient compression with error feedback still learns, and
    every residual stays within the 2^-8 grid."""
    _, cfg = _cfgs("gemma-2b", **TWO_LAYERS)
    api = build_model(cfg, device="cpu", remat=False)
    batch = synthetic_batch(cfg, DataConfig(16, 8), 0, device="cpu")
    step = make_train_step(api.loss_fn, AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=30),
                           grad_compress_bits=8)
    state = init_train_state(api.init_params(torch.Generator().manual_seed(0)), compress=True)
    losses = []
    for _ in range(10):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.3, losses
    assert max(float(r.abs().max()) for r in state.residual.values()) <= 2.0 ** -8 + 1e-6


def test_microbatches_must_divide_the_batch(two_layers):
    _, cfg, _, rparams, _ = two_layers
    api = build_model(cfg, device="cpu", remat=False)
    state = init_train_state(lm_params_from_jax(jax.tree.map(np.asarray, rparams), cfg))
    with pytest.raises(ValueError, match="equal microbatches"):
        make_train_step(api.loss_fn, AdamWConfig(**OPT), microbatches=3)(
            state, synthetic_batch(cfg, DataConfig(8, 4), 0, device="cpu"))
