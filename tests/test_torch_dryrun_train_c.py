"""Port parity, the dry run's train cells (part c of five, two cells
each, so that a file runs in under a minute): each ``train_4k`` cell of
``configs.cells()`` at smoke size through ``launch.dryrun.run_cell`` on
the single-pod fake mesh (16 × 16, a ``"fake"`` group of 512 ranks):
``make_train_step`` with the cell's 8 microbatches, remat and AdamW,
counted on meta tensors.
"""
import pytest

torch = pytest.importorskip("torch")

from torch_dryrun_cells import applicable, check_cell  # noqa: E402

TRAIN_CELLS = applicable({"train"})[4:6]


@pytest.fixture(scope="module")
def mesh():
    from repro_torch.launch.dryrun import fake_group
    from repro_torch.launch.mesh import make_production_mesh

    with fake_group():
        yield make_production_mesh(multi_pod=False, device_type="cpu")


@pytest.mark.parametrize("arch,shape", TRAIN_CELLS, ids=[f"{a}-{s}" for a, s in TRAIN_CELLS])
def test_train_cell_single_pod(mesh, tmp_path, arch, shape):
    rec = check_cell(arch, shape, mesh, "single_pod_16x16", 256, tmp_path)
    # AdamW's state rides in the arguments: parameters, μ and ν, each a shard
    assert rec["memory_analysis"]["argument_size_in_bytes"] >= 3 * 4 * rec["params"] / 256
