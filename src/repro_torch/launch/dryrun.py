"""Multi-pod dry run: every (architecture × input shape) cell on the
production meshes, counted on meta tensors (counterpart of
``repro.launch.dryrun``; no card needed).

    PYTHONPATH=src python -m repro_torch.launch.dryrun [--arch A] [--shape S]
        [--mesh single|multi|both] [--out experiments/torch_dryrun]

The reference forces 512 host devices and lets XLA lower and compile each
step.  The port builds a ``"fake"`` process group of 512 ranks in this one
process (``fake_group``; nothing is sent, every collective returns at
once), lays parameters, optimizer state, batch and cache out as DTensors
by ``distributed.sharding``'s rules on ``make_production_mesh``, and runs
the step once, eagerly, on meta tensors under ``CostCounter``, which counts
rank 0's local program (``roofline.structured.count_step``, the structured
roofline's count): the train step at ``MICROBATCHES`` (one microbatch's
forward and backward times their number, AdamW, and the data-parallel
gradient all-reduce added analytically, once), the prefill or one decode
step.

Per cell it writes ``<out>/<mesh>/<arch>__<shape>.json`` with the
reference's keys:
  - memory_analysis: ``argument_size_in_bytes`` (the local shards of every
    argument) and ``output_size_in_bytes`` (of every output), exact;
    ``temp_size_in_bytes`` and ``generated_code_size_in_bytes`` are null
    (see ``memory_analysis_note``)
  - cost_flops / cost_bytes: per device (``CostCounter``)
  - the roofline terms + bottleneck (``roofline``), the collectives by op
  - lower_s: seconds to build and lay out the stand-ins; compile_s:
    seconds of the counted run (there is no compile)

A cell that cannot be laid out or run fails loudly: ``FAIL`` and exit 1.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import traceback

from repro_torch.configs import (
    LONG_CONTEXT_ARCHS,
    LONG_SKIP_REASON,
    SHAPES,
    get_config,
    list_archs,
)
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.roofline.structured import count_step, local_bytes, step_terms

__all__ = ["MICROBATCHES", "FAKE_WORLD", "fake_group", "run_cell", "main"]

MICROBATCHES = {"train_4k": 8}
FAKE_WORLD = 512
MEMORY_NOTE = ("no XLA compile: argument/output sizes are the local shards of the "
               "step's arguments and outputs; temporaries and code size are not "
               "known without a compiler, and no peak is guessed")


@contextlib.contextmanager
def fake_group(world: int = FAKE_WORLD):
    """A ``"fake"`` process group of ``world`` ranks in this process (rank
    0), destroyed on exit.  Its collectives send nothing."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def run_cell(arch: str, shape_name: str, mesh, mesh_name: str, out_dir: str,
             opt_level: str = "baseline", cfg=None, shape=None) -> dict:
    """One cell, counted by ``roofline.structured.count_step`` and written.
    ``cfg`` / ``shape`` replace the registry's (tests pass reduced ones)."""
    cfg = cfg or get_config(arch)
    shape = shape or SHAPES[shape_name]
    sc = count_step(cfg, shape, mesh, microbatches=MICROBATCHES.get(shape_name, 1))
    rec = {
        "arch": arch, "shape": shape_name, "mesh": mesh_name, "chips": sc.chips,
        "opt_level": opt_level,
        "params": cfg.param_count(), "active_params": cfg.active_param_count(),
        "lower_s": round(sc.setup_s, 1), "compile_s": round(sc.run_s, 1),
        "memory_analysis": {
            "argument_size_in_bytes": local_bytes(sc.args),
            "output_size_in_bytes": local_bytes(sc.outputs),
            "temp_size_in_bytes": None,
            "generated_code_size_in_bytes": None,
        },
        "memory_analysis_note": MEMORY_NOTE,
        "cost_flops": sc.counter.flops,
        "cost_bytes": sc.counter.bytes,
        "flops_by_dtype": dict(sc.counter.flops_by_dtype),
        "roofline": step_terms(sc),
    }
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"{arch}__{shape_name}.json"), "w") as f:
        json.dump(rec, f, indent=1)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/torch_dryrun")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list_archs()
    shapes = [args.shape] if args.shape else list(SHAPES)
    failures = []
    with fake_group():
        meshes = []
        if args.mesh in ("single", "both"):
            meshes.append(("single_pod_16x16",
                           make_production_mesh(multi_pod=False, device_type="cpu")))
        if args.mesh in ("multi", "both"):
            meshes.append(("multi_pod_2x16x16",
                           make_production_mesh(multi_pod=True, device_type="cpu")))
        for mesh_name, mesh in meshes:
            out_dir = os.path.join(args.out, mesh_name)
            for arch in archs:
                for shape_name in shapes:
                    if shape_name == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
                        print(f"SKIP  {mesh_name:18s} {arch:22s} {shape_name}: "
                              f"{LONG_SKIP_REASON[arch]}")
                        continue
                    fn = os.path.join(out_dir, f"{arch}__{shape_name}.json")
                    if args.skip_existing and os.path.exists(fn):
                        print(f"have  {mesh_name:18s} {arch:22s} {shape_name}")
                        continue
                    try:
                        rec = run_cell(arch, shape_name, mesh, mesh_name, out_dir)
                        r = rec["roofline"]
                        print(
                            f"PASS  {mesh_name:18s} {arch:22s} {shape_name:12s} "
                            f"compile={rec['compile_s']:.0f}s "
                            f"compute={r['compute_s']:.2e}s memory={r['memory_s']:.2e}s "
                            f"coll={r['collective_s']:.2e}s bottleneck={r['bottleneck']}",
                            flush=True,
                        )
                    except Exception as e:
                        failures.append((mesh_name, arch, shape_name, repr(e)))
                        print(f"FAIL  {mesh_name:18s} {arch:22s} {shape_name}: {e!r}",
                              flush=True)
                        traceback.print_exc()
    if failures:
        print(f"\n{len(failures)} FAILURES")
        raise SystemExit(1)
    print("\nALL CELLS PASS")


if __name__ == "__main__":
    main()
