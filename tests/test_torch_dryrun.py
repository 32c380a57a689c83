"""Port parity, the dry-run drivers: ``launch.dryrun``, ``ppr_dryrun`` and
``roofline_run`` on a ``"fake"`` process group of 512 ranks (one
module-scoped group, destroyed on teardown).

- Every prefill and decode cell of ``configs.cells()`` at smoke size on the
  single-pod mesh (16 × 16) and a subset on the multi-pod mesh
  (2 × 16 × 16); the train cells are in ``test_torch_dryrun_train_*.py``,
  the CLIs in ``test_torch_dryrun_cli.py``.
- ``ppr_dryrun``'s step on a small workload on a (2, 4) mesh against the
  reference's compiled step in an 8-device subprocess: the collective bytes
  per device equal exactly (one all-gather of P, [V, κ_local] float32), and
  the FLOPs within the stated factor: the port counts ``FlopCounterMode``'s
  formulas (the dangling product, 2·V·κ_local) where XLA also counts the
  gather's multiplies, the segment sum's adds and the combine (7.0× here).
"""
import json
import os
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

from torch_dryrun_cells import applicable, check_cell  # noqa: E402

from repro_torch.configs.ppr_paper import PPRWorkload  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SERVE_CELLS = applicable({"prefill", "decode"})
MULTI_CELLS = [("gemma-2b", "decode_32k"), ("mixtral-8x7b", "prefill_32k"),
               ("zamba2-1.2b", "decode_32k"), ("whisper-medium", "prefill_32k"),
               ("gemma3-4b", "long_500k")]
SMALL = PPRWorkload("small", num_vertices=4096, num_edges=65536, kappa=4, bits=26)


@pytest.fixture(scope="module")
def meshes():
    from repro_torch.launch.dryrun import fake_group
    from repro_torch.launch.mesh import make_debug_mesh, make_production_mesh

    with fake_group():
        yield {"single": make_production_mesh(multi_pod=False, device_type="cpu"),
               "multi": make_production_mesh(multi_pod=True, device_type="cpu"),
               "2x4": make_debug_mesh(2, 4, device_type="cpu")}


@pytest.mark.parametrize("arch,shape", SERVE_CELLS, ids=[f"{a}-{s}" for a, s in SERVE_CELLS])
def test_serving_cell_single_pod(meshes, tmp_path, arch, shape):
    check_cell(arch, shape, meshes["single"], "single_pod_16x16", 256, tmp_path)


@pytest.mark.parametrize("arch,shape", MULTI_CELLS, ids=[f"{a}-{s}" for a, s in MULTI_CELLS])
def test_serving_cell_multi_pod(meshes, tmp_path, arch, shape):
    rec = check_cell(arch, shape, meshes["multi"], "multi_pod_2x16x16", 512, tmp_path)
    single = check_cell(arch, shape, meshes["single"], "single_pod_16x16", 256, tmp_path)
    if shape != "long_500k":    # twice the batch shards: at most the single pod's work
        assert rec["cost_flops"] <= single["cost_flops"]


# ---------------------------------------------------------------------------
# ppr_dryrun against the reference's compiled step
# ---------------------------------------------------------------------------
_REF_PPR = """
    import json, jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from repro.configs.ppr_paper import PPRWorkload
    from repro.launch.ppr_dryrun import build_ppr_step
    from repro.roofline.analysis import collective_bytes
    w = PPRWorkload("small", num_vertices=4096, num_edges=65536, kappa=4, bits=26)
    mesh = jax.make_mesh((2, 4), ("data", "model"), devices=jax.devices()[:8])
    step, specs, shardings = build_ppr_step(w, mesh)
    kp = NamedSharding(mesh, P("model", ("data",)))
    shardings = shardings[:3] + (kp, shardings[4], kp)
    c = jax.jit(step, in_shardings=shardings, out_shardings=kp).lower(*specs).compile()
    cost = c.cost_analysis()
    cost = cost[0] if isinstance(cost, list) else cost
    print(json.dumps({"flops": float(cost["flops"]), "bytes": float(cost["bytes accessed"]),
                      "colls": collective_bytes(c.as_text())}))
"""


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    env.update(extra)
    return env


def test_ppr_step_collective_bytes_equal_reference(meshes):
    from repro_torch.launch.ppr_dryrun import count_ppr_step

    out = subprocess.run([sys.executable, "-c", textwrap.dedent(_REF_PPR)],
                         capture_output=True, text=True, timeout=300,
                         env=_env(JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, out.stderr
    ref = json.loads(out.stdout.strip().splitlines()[-1])
    got = count_ppr_step(SMALL, meshes["2x4"], "2x4")
    assert got["collectives"] == {"all-gather": ref["colls"]["all-gather"]} == \
        {"all-gather": SMALL.num_vertices * SMALL.kappa * 4}
    assert got["collective_bytes_per_device"] == sum(ref["colls"].values())
    assert got["kappa_total"] == SMALL.kappa * 2
    assert got["flops_per_device"] == 2 * SMALL.num_vertices * SMALL.kappa
    factor = ref["flops"] / got["flops_per_device"]
    assert 1.0 <= factor <= 8.0, factor
