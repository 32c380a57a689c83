"""Structured (trip-count-correct) roofline for every cell on the single-pod
mesh (counterpart of ``repro.launch.roofline_run``; no card needed).

    PYTHONPATH=src python -m repro_torch.launch.roofline_run [--arch A] [--shape S]
        [--out experiments/torch_roofline] [--variant baseline]

Runs ``structured_roofline`` on ``make_production_mesh`` over a ``"fake"``
process group of 512 ranks (``dryrun.fake_group``).  The terms are
predictions from the H100 constants of ``roofline.analysis``, not times.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
import traceback

import torch

from repro_torch.configs import LONG_CONTEXT_ARCHS, SHAPES, get_config, list_archs
from repro_torch.launch.dryrun import MICROBATCHES, fake_group
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.roofline.structured import structured_roofline

__all__ = ["VARIANTS", "resolve_overrides", "main"]

# the reference's variants, by name.  "baseline"/"final"/"it1_moe_sharding"
# share overrides={} (the MoE dispatch pins are in the library).
VARIANTS = {
    "baseline": {},
    "final": {},
    "it1_moe_sharding": {},
    # decode: local-attention layers keep only `window` KV entries
    "it_windowed_kv": {"cache_len": "windowed"},
    # decode: KV stored in int8 (the paper's truncation quantization on state)
    "it_int8_kv": {"cache_len": "windowed", "kv_dtype": torch.int8},
    # decode: + int8 weight streaming
    "it_int8_weights": {"cache_len": "windowed", "kv_dtype": torch.int8,
                        "param_dtype": torch.int8},
    "it_int8_kv_only": {"kv_dtype": torch.int8},
    "it_int8_all": {"kv_dtype": torch.int8, "param_dtype": torch.int8},
    # train/prefill: disable sequence parallelism (batch-only activations)
    "it_no_sp": {"sequence_parallel": False},
    # train: 12-bit fixed-point gradient all-reduce w/ error feedback,
    # wire format (1 sign + 2 int + 12 frac)/32 = 15/32
    "it_compressed_ar": {"grad_ar_scale": 15.0 / 32.0},
    "it_no_sp_compressed_ar": {"sequence_parallel": False, "grad_ar_scale": 15.0 / 32.0},
    # MoE: tight capacity (1.0)
    "it_cap1": {"cfg": {"moe_capacity_factor": 1.0}},
    "it_cap1_compressed": {"cfg": {"moe_capacity_factor": 1.0},
                           "grad_ar_scale": 15.0 / 32.0},
}


def resolve_overrides(name: str, shape) -> dict:
    ov = dict(VARIANTS[name])
    if ov.get("cache_len") == "windowed":
        smax = shape.seq_len
        ov["cache_len"] = lambda w: min(w, smax) if w else smax
    return ov


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--out", default="experiments/torch_roofline")
    ap.add_argument("--variant", default="baseline", choices=sorted(VARIANTS))
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    archs = [args.arch] if args.arch else list_archs()
    shapes = [args.shape] if args.shape else list(SHAPES)
    out_dir = os.path.join(args.out, args.variant)
    os.makedirs(out_dir, exist_ok=True)
    failures = []
    with fake_group():
        mesh = make_production_mesh(multi_pod=False, device_type="cpu")
        for arch in archs:
            for shape_name in shapes:
                if shape_name == "long_500k" and arch not in LONG_CONTEXT_ARCHS:
                    continue
                fn = os.path.join(out_dir, f"{arch}__{shape_name}.json")
                if args.skip_existing and os.path.exists(fn):
                    continue
                cfg = get_config(arch)
                shape = SHAPES[shape_name]
                t0 = time.time()
                try:
                    overrides = resolve_overrides(args.variant, shape)
                    if "cfg" in overrides:
                        cfg = dataclasses.replace(cfg, **overrides.pop("cfg"))
                    rec = structured_roofline(
                        cfg, shape, mesh, microbatches=MICROBATCHES.get(shape_name, 1),
                        overrides=overrides)
                    rec.update(arch=arch, shape=shape_name, variant=args.variant,
                               wall_s=round(time.time() - t0, 1))
                    with open(fn, "w") as f:
                        json.dump(rec, f, indent=1)
                    print(f"OK    {arch:22s} {shape_name:12s} "
                          f"compute={rec['compute_s']:.3e} memory={rec['memory_s']:.3e} "
                          f"coll={rec['collective_s']:.3e} {rec['bottleneck']:10s} "
                          f"useful={rec['useful_flops_ratio']:.3f} ({rec['wall_s']}s)",
                          flush=True)
                except Exception as e:
                    failures.append((arch, shape_name, repr(e)))
                    print(f"FAIL  {arch:22s} {shape_name}: {e!r}", flush=True)
                    traceback.print_exc()
    if failures:
        raise SystemExit(f"{len(failures)} failures")
    print("ALL STRUCTURED ROOFLINES DONE")


if __name__ == "__main__":
    main()
