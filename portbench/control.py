"""The readings the correctness limits are set from, at a cell's own size.

    python3 portbench/control.py --workload <cell> --seeds 11,12,13 \\
        --seconds 3 [--control]

Without ``--control``: the program's readings, one short window of the
cell's own traffic per seed, through the same harness as a run.  With
``--control``: the control's.  For a fixed-point cell that is the program's
own next format down (Q1.23 for Q1.25, registered and served in place of
the stated one) judged against the stated format; for a float32 cell, the
plain reference computed in bfloat16, put in the program's place for the
queries the cell's stream sends first.  One JSON line a seed, and the
largest reading of each number over the seeds last.  The benchmark's own
runs never run this.
"""
import argparse
import copy
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def lowered(cell):
    """``cell`` served at the next Q format down (Q1.f -> Q1.(f-2)), still
    judged by its own check."""
    cell = copy.deepcopy(cell)
    bits = int(cell.traffic["precision"]) - 2
    cell.traffic["precision"] = bits
    cell.config["service"]["formats"] = [bits]
    return cell


def bf16_numbers(cell, seed: int, n: int, device):
    """The float check's numbers for answers of the reference in bfloat16 to
    the first ``n`` queries of the cell's stream on the seed's graph."""
    import numpy as np
    import torch

    from portbench import arrivals, graphgen, reference as ref, verdict

    gspec, sspec, tr = cell.config["graph"], cell.config["service"], cell.traffic
    nv, k = int(gspec["num_vertices"]), int(tr["k"])
    src, dst = graphgen.make_graph(gspec, arrivals.rng_for(seed, "graph"))
    verts = arrivals.VertexStream(tr["vertices"], nv, seed).draw(n)
    g = ref.RefGraph(src, dst, nv, device)
    ids, scores = [], []
    for b in range(0, n, 64):
        cols = verts[b:b + 64]
        P = ref.ppr_float(g, cols, float(sspec["alpha"]), int(sspec["iterations"]),
                          dtype=torch.bfloat16)
        i, s = ref.topk_float(P, cols, k)
        ids.append(i)
        scores.append(s)
    del g
    answers = {"vertex": verts, "version": np.zeros(n, np.int32),
               "ids": np.concatenate(ids), "scores": np.concatenate(scores)}
    check = json.loads((verdict.CHECKS / f"{tr['check']}.json").read_text())
    return verdict.judge(check, lambda j: (src, dst, nv), answers, device,
                         alpha=float(sspec["alpha"]),
                         iterations=int(sspec["iterations"]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    from portbench import harness

    cell = harness.load_cell(args.workload)
    fixed = cell.traffic["precision"] != "f32"
    worst = {}
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        if args.control and not fixed:
            numbers = bf16_numbers(cell, seed, 256, "cuda")
            numbers.pop("checked")
        else:
            run = harness.run_cell(lowered(cell) if args.control else cell, seed,
                                   args.seconds, False, device="cuda")
            numbers = {m: c["value"] for m, c in run["checks"].items()}
        for m, v in numbers.items():
            worst[m] = max(worst.get(m, v), v)
        print(json.dumps({"seed": seed, "control": args.control, "numbers": numbers,
                          "s": time.perf_counter() - t}), flush=True)
    print(json.dumps({"workload": args.workload, "control": args.control,
                      "largest": worst}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
