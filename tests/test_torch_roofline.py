"""Port parity, ``roofline/`` and ``configs.cells``: the H100 constants, the
roofline terms and model FLOPs against the reference's, the per-device
counting, and the structured roofline at smoke size.

The counts run on meta tensors as DTensors on a ``"fake"`` process group of
256 ranks (one module-scoped group, destroyed on teardown), on the
single-pod mesh ``make_production_mesh`` (16 × 16).

Structured roofline, counted FLOPs × chips against the analytic 6·N·T
(train) / 2·N·T (prefill), at smoke size (S = 256, 8 microbatches of 32
rows for train): measured 1.78 / 1.31 (gemma-2b), 2.42 / 1.77 (mixtral),
2.00 / 1.49 (mamba2), 1.16 / 0.86 (whisper) on a 1 × 1 mesh, and 3.88,
2.45, 3.00, 1.37 for train on the 16 × 16 mesh.  What makes the factor:
remat (4/3 on the layers), attention at S = 256 against a 128-wide model,
the float32 head; for MoE the capacity padding (the smoke configs are
dropless, capacity factor 4, so the dense E·cap expert slots hold ~4× the
routed tokens and all are counted); whisper's encoder sees 16 frames, not
S tokens (< 1 on prefill); on 16 × 16 DTensor's sequence-parallel program
recomputes parts of the backward on gathered activations (~2× for
gemma-2b).  The gates: train within [1, 4.5], prefill within [0.8, 2.5].
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

from repro.configs import cells as rcells  # noqa: E402
from repro.configs import get_config as rget_config  # noqa: E402
from repro.roofline import analysis as ranalysis  # noqa: E402
from repro_torch.configs import cells, get_config, list_archs, smoke_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.roofline import analysis as tanalysis  # noqa: E402

HLO_FIXTURE = """
  %x = f32[256,4096]{1,0} parameter(0)
  %ar = f32[256,4096]{1,0} all-reduce(f32[256,4096]{1,0} %x), replica_groups={}
  %ag = bf16[64,128]{1,0} all-gather(bf16[32,128]{1,0} %y), dimensions={0}
  %rs = f32[16]{0} reduce-scatter(f32[256]{0} %z), dimensions={0}
  %cp = u32[8,8]{1,0} collective-permute(u32[8,8]{1,0} %w), source_target_pairs={}
"""


def test_h100_constants():
    """NVIDIA H100 SXM data sheet: bf16 dense, float32 outside the tensor
    cores, HBM3, NVLink 4 one way; no TPU constant and no ``ICI_BW``."""
    assert tanalysis.PEAK_FLOPS == 989e12
    assert tanalysis.PEAK_FLOPS_F32 == 67e12
    assert tanalysis.HBM_BW == 3.35e12
    assert tanalysis.LINK_BW == 450e9
    assert not hasattr(tanalysis, "ICI_BW")


@pytest.mark.parametrize("chips,flops,nbytes,mflops", [
    (4, 989e12, 3.35e12 * 2, 989e12 * 2),
    (256, 1e15, 1e9, 0.0),
    (1, 1e9, 1e14, 3e9),
])
def test_roofline_terms_equal_reference_on_the_same_numbers(monkeypatch, chips, flops,
                                                            nbytes, mflops):
    """The reference's ``roofline`` with its constants set to the H100's
    (inside this test only) gives the port's terms and bottleneck."""
    monkeypatch.setattr(ranalysis, "HBM_BW", tanalysis.HBM_BW)
    monkeypatch.setattr(ranalysis, "ICI_BW", tanalysis.LINK_BW)
    monkeypatch.setattr(ranalysis, "PEAK_FLOPS", tanalysis.PEAK_FLOPS)
    cost = {"flops": flops, "bytes accessed": nbytes}
    want = ranalysis.roofline(cost, HLO_FIXTURE, chips, model_flops=mflops,
                              peak_flops=tanalysis.PEAK_FLOPS).as_dict()
    got = tanalysis.roofline(cost, ranalysis.collective_bytes(HLO_FIXTURE), chips,
                             model_flops=mflops).as_dict()
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        if isinstance(v, float):
            assert got[k] == pytest.approx(v, rel=1e-15), k
        else:
            assert got[k] == v, k


def test_model_flops_and_cells_equal_reference():
    assert cells() == rcells()
    for arch in list_archs():
        for tokens in (1, 4096, 256 * 4096):
            assert tanalysis.model_flops_train(get_config(arch), tokens) == \
                ranalysis.model_flops_train(rget_config(arch), tokens)
            assert tanalysis.model_flops_forward(get_config(arch), tokens) == \
                ranalysis.model_flops_forward(rget_config(arch), tokens)


# ---------------------------------------------------------------------------
# per-device counting on the fake 16 × 16 mesh
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def mesh():
    from repro_torch.launch.dryrun import fake_group
    from repro_torch.launch.mesh import make_production_mesh

    with fake_group(256):
        yield make_production_mesh(multi_pod=False, device_type="cpu")


def _dt(mesh, shape, spec):
    from repro_torch.distributed.sharding import distribute

    return distribute(torch.empty(shape, device="meta"), mesh, spec)


def test_sharded_product_counts_global_over_chips(mesh):
    """A product sharded over both axes (rows over data, columns over model)
    counts 2·M·K·N / 256 on each device, and moves no collective."""
    a = _dt(mesh, (4096, 512), ("data", None))
    w = _dt(mesh, (512, 2048), (None, "model"))
    with tanalysis.CostCounter() as c:
        a @ w
    assert c.flops == 2 * 4096 * 512 * 2048 / 256
    assert c.flops_by_dtype == {"float32": c.flops}
    assert dict(c.collectives) == {}
    # bytes: each device reads its shards and writes its block
    assert c.bytes == 4 * (4096 * 512 / 16 + 512 * 2048 / 16 + 4096 * 2048 / 256)


def test_replicated_op_counts_the_whole_op_on_every_device(mesh):
    x = _dt(mesh, (64, 1024), ())
    w = _dt(mesh, (1024, 256), ())
    with tanalysis.CostCounter() as c:
        x @ w
    assert c.flops == 2 * 64 * 1024 * 256
    with tanalysis.CostCounter() as c:
        torch.nn.functional.rms_norm(x, (1024,))
    assert c.flops == 0.0 and c.bytes >= 2 * 64 * 1024 * 4     # read x, write y at least


def test_collective_bytes_of_a_known_redistribute(mesh):
    """Shard(0) over model → replicated: an all-gather whose result is the
    whole [256, 64] float32 on each device; a pending sum → replicated: an
    all-reduce of the local block."""
    from torch.distributed.tensor import Partial, Replicate

    x = _dt(mesh, (256, 64), (None,))
    y = _dt(mesh, (256, 64), ("model",))
    with tanalysis.CostCounter() as c:
        y.redistribute(y.device_mesh, x.placements)
    assert tanalysis.collective_bytes(c) == {"all-gather": 256 * 64 * 4}
    p = torch.distributed.tensor.DTensor.from_local(
        torch.empty((32, 8), device="meta"), mesh, [Replicate(), Partial()])
    with tanalysis.CostCounter() as c:
        p.redistribute(mesh, [Replicate(), Replicate()])
    assert tanalysis.collective_bytes(c) == {"all-reduce": 32 * 8 * 4}


@pytest.mark.parametrize("arch", ["gemma-2b", "mixtral-8x7b", "mamba2-1.3b",
                                  "whisper-medium"])
def test_structured_roofline_within_stated_factor_of_analytic(mesh, arch):
    from repro_torch.roofline.structured import structured_roofline

    cfg = smoke_config(get_config(arch))
    if cfg.ssm_state:     # 16 SSM heads, so that the rules' 16-way model axis divides them
        cfg = dataclasses.replace(cfg, ssm_head_dim=16)
    train = structured_roofline(cfg, ShapeConfig("t", "train", 256, 256), mesh,
                                microbatches=8)
    prefill = structured_roofline(cfg, ShapeConfig("p", "prefill", 256, 32), mesh)
    for rec, lo, hi in ((train, 1.0, 4.5), (prefill, 0.8, 2.5)):
        factor = rec["flops_per_device"] * rec["chips"] / rec["model_flops"]
        assert lo <= factor <= hi, (arch, factor)
        assert rec["chips"] == 256
        terms = {k: rec[f"{k}_s"] for k in ("compute", "memory", "collective")}
        assert rec["bottleneck"] == max(terms, key=terms.get)
        assert np.isclose(rec["compute_s"], rec["flops_per_device"] / tanalysis.PEAK_FLOPS)
        assert rec["collective_bytes_per_device"] == sum(rec["collectives"].values())
    # the one gradient all-reduce is the analytic one, added once
    from repro_torch.models.transformer import Transformer
    from repro_torch.roofline.structured import local_param_bytes

    ar = local_param_bytes(Transformer(cfg, None, torch.device("meta")), mesh, cfg)
    assert ar > 0 and train["collectives"]["all-reduce"] >= ar
