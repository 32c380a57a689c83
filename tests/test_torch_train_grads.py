"""Port parity, training slice: ``loss_fn`` and every gradient leaf against
``jax.grad`` of the reference's ``loss_fn``, for the dense decoder-only
architectures at smoke widths in float32 (mixtral, moonshot, mamba2 and
zamba2 are in ``test_torch_train_grads_moe_ssm.py``, which shares
``check_loss_and_gradients``; whisper-medium and phi-3-vision-4.2b are in
``test_torch_lm_encdec.py``), with the reference's
``init_params(PRNGKey(0))`` carried into the port and the batch from
``synthetic_batch`` (array-equal in both packages).

Loss: rtol 2e-5.  Gradients: rtol 1e-4 with atol 1e-4 of the leaf's
largest reference value (measured: ≤ 4e-5 of it, zamba2; the SSM layers'
repaired segment sums differ from the reference's by ~1e-7, ROADMAP
queue 3).  MoE: gradients reach the router through the gate values, not the
routing; a route that two float32 routers may order differently would move
the loss by far more than the tolerance, so the test checks that no token's
k-th and (k+1)-th gates lie within 1e-4 on this seed (the smallest gap is
reported in the failure).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import get_config as rget_config  # noqa: E402
from repro.configs import smoke_config as rsmoke  # noqa: E402
from repro.data import DataConfig as RDataConfig  # noqa: E402
from repro.data import synthetic_batch as rsynthetic_batch  # noqa: E402
from repro.models import build_model as rbuild  # noqa: E402
from repro_torch.configs import get_config, smoke_config  # noqa: E402
from repro_torch.convert import leaf_at, lm_name_map, lm_params_from_jax  # noqa: E402
from repro_torch.data import DataConfig, synthetic_batch  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402

ARCHS = ["gemma-2b", "gemma2-27b", "starcoder2-15b", "gemma3-4b"]
GATE_GAP = 1e-4


def check_loss_and_gradients(arch, monkeypatch):
    rcfg = dataclasses.replace(rsmoke(rget_config(arch)), compute_dtype="float32")
    cfg = dataclasses.replace(smoke_config(get_config(arch)), compute_dtype="float32")
    rapi = rbuild(rcfg, remat=False)
    rparams = jax.jit(rapi.init_params)(jax.random.PRNGKey(0))
    np_params = jax.tree.map(np.asarray, rparams)
    params = lm_params_from_jax(np_params, cfg, trainable=True)
    api = build_model(cfg, device="cpu", remat=True)
    gaps = []
    route = tmoe.route

    def recording_route(x, router, cfg_):
        with torch.no_grad():
            gates = torch.softmax((x @ router.to(x.dtype)).to(torch.float32), dim=-1)
            top = torch.sort(gates, dim=-1, descending=True).values
            k = cfg_.experts_per_token
            gaps.append(float((top[..., k - 1] - top[..., k]).min()))
        return route(x, router, cfg_)

    monkeypatch.setattr(tmoe, "route", recording_route)
    rbatch = rsynthetic_batch(rcfg, RDataConfig(seq_len=16, global_batch=2), 0)
    rloss, rgrads = jax.jit(jax.value_and_grad(rapi.loss_fn))(rparams, rbatch)
    loss = api.loss_fn(params, synthetic_batch(cfg, DataConfig(16, 2), 0, device="cpu"))
    loss.backward()
    assert (min(gaps) > GATE_GAP) if cfg.num_experts else not gaps, min(gaps or [0])
    assert float(loss.detach()) == pytest.approx(float(rloss), rel=2e-5)
    names = lm_name_map(np_params, cfg)
    assert sorted(names) == sorted(n for n, _ in params.named_parameters())
    for name, p in params.named_parameters():
        path, idx = names[name]
        want = np.asarray(leaf_at(rgrads, path))[idx]
        np.testing.assert_allclose(p.grad.numpy(), want, rtol=1e-4,
                                   atol=1e-4 * np.abs(want).max(), err_msg=name)


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_gradients_match_reference(arch, monkeypatch):
    check_loss_and_gradients(arch, monkeypatch)
