"""Dry run of the paper's own workload on the production meshes: the
dst-partitioned streaming SpMV PPR iteration, counted at pod scale
(counterpart of ``repro.launch.ppr_dryrun``; no card needed).

    PYTHONPATH=src python -m repro_torch.launch.ppr_dryrun [--workload ppr-pod-16m]
        [--out experiments/torch_dryrun]

The model axis partitions the vertex space (the paper's URAM → per-device
memory); the data axes batch independent κ-groups of personalization
vertices (the paper's request batching, scaled 16×).

The step is the reference's ``shard_map`` body written as one device's
local program: an all-gather of P's dst shard over the "model" group
(``torch.distributed._functional_collectives``), the gather of P rows by
each local edge's source and ``index_add_`` into the shard's rows, and
the dangling term.  It runs on meta tensors, on a ``"fake"`` process group
of 512 ranks, under ``CostCounter``.  This is the reference's plain
program (a gather and a segment sum), not the fused kernel.
"""
from __future__ import annotations

import argparse
import json
import os

import torch

from repro_torch.configs.ppr_paper import PPR_WORKLOADS, PPRWorkload
from repro_torch.distributed.sharding import axis_sizes
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.roofline.analysis import HBM_BW, LINK_BW, CostCounter, collective_bytes

__all__ = ["build_ppr_step", "count_ppr_step", "main"]

META = torch.device("meta")


def build_ppr_step(w: PPRWorkload, mesh):
    """One PPR iteration over the dst-partitioned COO graph, κ batched over
    the data axes.  Returns (step, local inputs): ``step`` is one device's
    program; the inputs are that device's shards, on ``meta``."""
    from torch.distributed import _functional_collectives as funcol

    sizes = axis_sizes(mesh)
    n_model = sizes["model"]
    n_data = sizes["data"] * sizes.get("pod", 1)
    v_local = w.num_vertices // n_model
    e_shard = w.num_edges // n_model
    k_local = w.kappa        # κ_total = κ · n_data columns, sharded over the data axes

    def step(x_l, y_l, v_l, p_shard, dang, pmat):
        # p arrives dst-sharded (the previous iteration's output); the step
        # all-gathers it over the model axis: the partitioned design's real
        # per-iteration collective (paper §4.1.2 partitioning trade-off)
        p_full = funcol.all_gather_tensor(p_shard, 0, mesh.get_group("model"))
        p_full = funcol.wait_tensor(p_full)
        contrib = v_l[:, None] * p_full[y_l]                     # gather full p rows
        xp = torch.zeros((v_local, p_full.shape[1]), dtype=contrib.dtype,
                         device=contrib.device).index_add_(0, x_l, contrib)
        dangling_mass = dang @ p_full                            # [K]
        return (w.alpha * xp
                + (w.alpha / w.num_vertices) * dangling_mass[None, :]
                + (1 - w.alpha) * pmat)

    inputs = (
        torch.empty((e_shard,), dtype=torch.int32, device=META),     # x (local dst)
        torch.empty((e_shard,), dtype=torch.int32, device=META),     # y (global src)
        torch.empty((e_shard,), dtype=torch.float32, device=META),   # val
        torch.empty((v_local, k_local), dtype=torch.float32, device=META),   # P_t shard
        torch.empty((w.num_vertices,), dtype=torch.float32, device=META),    # dangling
        torch.empty((v_local, k_local), dtype=torch.float32, device=META),   # personalization
    )
    return step, inputs


def count_ppr_step(w: PPRWorkload, mesh, mesh_name: str) -> dict:
    """The step counted on ``mesh``, as the reference's JSON record."""
    step, inputs = build_ppr_step(w, mesh)
    with CostCounter() as c:
        step(*inputs)
    sizes = axis_sizes(mesh)
    colls = collective_bytes(c)
    cb = float(sum(colls.values()))
    return {
        "workload": w.name, "mesh": mesh_name,
        "V": w.num_vertices, "E": w.num_edges,
        "kappa_total": w.kappa * sizes["data"] * sizes.get("pod", 1),
        "flops_per_device": c.flops, "bytes_per_device": c.bytes,
        "collective_bytes_per_device": cb, "collectives": colls,
        "memory_s": c.bytes / HBM_BW, "collective_s": cb / LINK_BW,
    }


def main(argv=None):
    from repro_torch.launch.dryrun import fake_group

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", default="ppr-pod-16m", choices=sorted(PPR_WORKLOADS))
    ap.add_argument("--out", default="experiments/torch_dryrun")
    args = ap.parse_args(argv)
    w = PPR_WORKLOADS[args.workload]
    with fake_group():
        for mesh_name, multi in [("single_pod_16x16", False), ("multi_pod_2x16x16", True)]:
            mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
            rec = count_ppr_step(w, mesh, mesh_name)
            os.makedirs(args.out, exist_ok=True)
            with open(os.path.join(args.out, f"ppr__{w.name}__{mesh_name}.json"), "w") as f:
                json.dump(rec, f, indent=1)
            print(f"PASS  {mesh_name:18s} {w.name}: memory_s={rec['memory_s']:.3e} "
                  f"coll_s={rec['collective_s']:.3e} "
                  f"(per-iteration, {rec['kappa_total']} concurrent requests)", flush=True)


if __name__ == "__main__":
    main()
