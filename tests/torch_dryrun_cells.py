"""Shared by the port's dry-run tests: each cell of ``configs.cells()`` at
smoke size through ``launch.dryrun.run_cell`` on a fake production mesh.

Smoke size: ``smoke_config`` of the arch (SSM head width 16, so that
mamba2/zamba2 have 16 heads and the rules' 16-way model axis divides
their per-head parameters, as it divides the full configs'), at the
shape's own global batch with a short sequence (meta tensors cost
nothing per element; the op count is what takes time).
"""
import dataclasses
import json
import os

from repro_torch.configs import SHAPES, cells, get_config, smoke_config

SMOKE_SEQ = {"train_4k": 256, "prefill_32k": 512, "decode_32k": 512, "long_500k": 1024}
KEYS = {"arch", "shape", "mesh", "chips", "opt_level", "params", "active_params", "lower_s",
        "compile_s", "memory_analysis", "cost_flops", "cost_bytes", "roofline"}
ROOFLINE_KEYS = {"flops_per_device", "bytes_per_device", "collective_bytes_per_device",
                 "collectives", "chips", "compute_s", "memory_s", "collective_s",
                 "bottleneck", "model_flops", "useful_flops_ratio", "peak_flops"}


def smoke_cell(arch, shape_name):
    cfg = smoke_config(get_config(arch))
    if cfg.ssm_state:
        cfg = dataclasses.replace(cfg, ssm_head_dim=16)
    return cfg, dataclasses.replace(SHAPES[shape_name], seq_len=SMOKE_SEQ[shape_name])


def applicable(kinds):
    return [(a, s) for a, s, ok, _ in cells() if ok and SHAPES[s].kind in kinds]


def check_cell(arch, shape_name, mesh, mesh_name, chips, out_dir):
    from repro_torch.distributed.sharding import axis_sizes
    from repro_torch.launch.dryrun import MICROBATCHES, run_cell
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.roofline.structured import count_step

    cfg, shape = smoke_cell(arch, shape_name)
    rec = run_cell(arch, shape_name, mesh, mesh_name, str(out_dir), cfg=cfg, shape=shape)
    with open(os.path.join(out_dir, f"{arch}__{shape_name}.json")) as f:
        assert json.load(f) == json.loads(json.dumps(rec))
    assert KEYS <= set(rec) and ROOFLINE_KEYS <= set(rec["roofline"])
    assert rec["chips"] == chips and rec["roofline"]["chips"] == chips
    assert rec["cost_flops"] > 0 and rec["cost_bytes"] > 0
    mem = rec["memory_analysis"]
    assert mem["argument_size_in_bytes"] > 0 and mem["output_size_in_bytes"] > 0
    assert mem["temp_size_in_bytes"] is None and "memory_analysis_note" in rec
    r = rec["roofline"]
    terms = {k: r[f"{k}_s"] for k in ("compute", "memory", "collective")}
    assert r["bottleneck"] == max(terms, key=terms.get)
    # the step on chips devices does at least the analytic work between them
    # (2·N·T or 6·N·T, N the active parameters), less what whisper's short
    # smoke encoder skips
    assert r["useful_flops_ratio"] < 1.25, (arch, shape_name, r["useful_flops_ratio"])
    # and at most twice the same step counted on one device, times the data
    # devices that replicate a batch they cannot split (long_500k's batch 1):
    # sharding divides the work, it adds little (what a layout leaves whole
    # on each model device, such as whisper's 1,500 encoder positions).  It
    # may do less: a device's shorter query chunks cut a sliding window's
    # masked span.
    replicate = chips // axis_sizes(mesh)["model"]
    replicate = 1 if shape.global_batch % replicate == 0 else replicate
    one = count_step(cfg, shape, make_debug_mesh(1, 1, device_type="cpu"),
                     MICROBATCHES.get(shape_name, 1))
    spread = rec["cost_flops"] * chips / one.counter.flops
    assert spread <= 2 * replicate, (arch, shape_name, spread)
    return rec
