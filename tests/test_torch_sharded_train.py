"""Port parity, ``distributed/`` on a mesh that shards: one train step on a
(2, 2) ("data", "model") mesh of 4 spawned gloo CPU processes against the
same step unsharded.

For a dense (gemma-2b), an MoE (mixtral-8x7b) and an SSM (mamba2-1.3b)
arch at ``smoke_config`` widths cut to 2 layers, float32, batch 4 × 32
tokens from ``synthetic_batch``: the parameters as DTensors by the rules,
the batch over "data", ``set_sharding_context(mesh)``, and
``make_train_step`` at 1 and 2 microbatches.  This runs what a 1×1 mesh
never does with values: the vocab-sharded head and loss, ``shard_heads``'
re-layouts, ``_Pin``'s gradient redistribution, the MoE dispatch, scatter
and combine regions, the SSD scan's region with its pending-sum
gradients, and the per-device microbatch split.

Then, under the same mesh, a prefill into a cache laid out by
``cache_specs`` and two decode steps: the vocab-sharded lookup, the cache
writes of ``write_positions`` and the per-head SSM recurrence.

The loss, every gradient leaf (as AdamW receives it) and every parameter
after the step are held to the unsharded step at
``tests/test_train.py:57``'s rtol 2e-4 / atol 2e-5 (float32 sums in
another order), gathered with ``full_tensor()``.  Parameters where √v̂ <
1e-6 leave it, as in ``tests/test_torch_train.py``: there Adam's direction
is ill-conditioned, and they are held to |Δp| ≤ 2.5·lr and counted (a few
in 10^5).  A batch whose rows on a device do not split into the
microbatches is refused, on every rank.
"""
import json
import os
import socket
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARCHS = ["gemma-2b", "mixtral-8x7b", "mamba2-1.3b"]
MICROBATCHES = [1, 2]

_RANKS = """
    import dataclasses, json, os, torch, torch.distributed as dist
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD"])
    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:" + os.environ["PORT"],
                            rank=rank, world_size=world)
    torch.set_num_threads(1)
    from torch.distributed.tensor.experimental import implicit_replication
    from repro_torch.configs import get_config, smoke_config
    from repro_torch.data import DataConfig, synthetic_batch
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.models.transformer import build_model
    from repro_torch.training import AdamWConfig, train_loop
    from repro_torch.training.train_loop import init_train_state, make_train_step

    TOL = dict(rtol=2e-4, atol=2e-5)
    ILL = 1e-6
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    mesh = make_debug_mesh(2, 2, device_type="cpu")
    seen = []
    adamw = train_loop.adamw_update

    def spy(cfg, grads, state, params):        # the gradients AdamW receives
        seen.append({k: (g.full_tensor() if hasattr(g, "full_tensor") else g).clone()
                     for k, g in grads.items()})
        return adamw(cfg, grads, state, params)

    train_loop.adamw_update = spy

    def full(t):
        return (t.full_tensor() if hasattr(t, "full_tensor") else t).detach()

    out = {}
    for arch in os.environ["ARCHS"].split(","):
        cfg = dataclasses.replace(smoke_config(get_config(arch)), compute_dtype="float32",
                                  num_layers=2)
        api = build_model(cfg, device="cpu", remat=True)
        batch = synthetic_batch(cfg, DataConfig(seq_len=32, global_batch=4), 0, "cpu")

        def fresh():
            return api.init_params(torch.Generator().manual_seed(0))

        def sharded(microbatches):
            params = shd.distribute_params(fresh(), mesh, cfg)
            specs = shd.batch_specs(batch, mesh)
            dbatch = {k: shd.distribute(v, mesh, specs[k], k) for k, v in batch.items()}
            step = make_train_step(api.loss_fn, opt, microbatches=microbatches)
            shd.set_sharding_context(mesh)
            try:
                with implicit_replication():
                    return step(init_train_state(params), dbatch)
            finally:
                shd.set_sharding_context(None)

        for mb in (1, 2):
            seen.clear()
            want, wm = make_train_step(api.loss_fn, opt, microbatches=mb)(
                init_train_state(fresh()), batch)
            got, gm = sharded(mb)
            wgrad, ggrad = seen
            wp = dict(want.params.named_parameters())
            rec = {"loss": [float(full(gm["loss"])), float(wm["loss"])], "bad_grads": [],
                   "bad_params": [], "grad_max": 0.0, "param_max": 0.0, "ill": 0,
                   "elements": 0, "leaves": len(wp)}
            b2c = 1 - opt.b2
            for n, p in got.params.named_parameters():
                g, w = ggrad[n], wgrad[n]
                rec["grad_max"] = max(rec["grad_max"], float((g - w).abs().max()))
                if not torch.allclose(g, w, **TOL):
                    rec["bad_grads"].append(n)
                p, w = full(p), wp[n].detach()
                rec["param_max"] = max(rec["param_max"], float((p - w).abs().max()))
                off = ~torch.isclose(p, w, **TOL)
                ill = torch.sqrt(want.opt.nu[n] / b2c) < ILL
                if (off & ~ill).any() or ((p - w).abs()[off] > 2.5 * opt.lr).any():
                    rec["bad_params"].append(n)
                rec["ill"] += int((off & ill).sum())
                rec["elements"] += p.numel()
            out[f"{arch}/{mb}"] = rec

        # serving: prefill 24 of the batch's tokens into a 48-slot cache,
        # then decode two more, sharded against unsharded
        def serve(params, mesh_or_none):
            cache = api.init_cache(4, 48)
            prompt = {"tokens": batch["tokens"][:, :24]}
            steps = [batch["tokens"][:, 24 + i:25 + i] for i in range(2)]
            if mesh_or_none is not None:
                cache = shd.distribute_tree(cache, shd.cache_specs(cache, mesh, 4), mesh)
                prompt = shd.distribute_tree(prompt, shd.batch_specs(prompt, mesh), mesh)
                steps = [shd.distribute(t, mesh, ("data",), "token") for t in steps]
            logits = []
            for i, step in enumerate([None] + steps):
                if mesh_or_none is not None:
                    shd.set_sharding_context(mesh, sequence_parallel=step is None)
                try:
                    with implicit_replication():
                        if step is None:
                            lg, cache = api.prefill(params, prompt, cache)
                        else:
                            lg, cache = api.decode_step(params, step, 23 + i, cache)
                finally:
                    shd.set_sharding_context(None)
                logits.append(full(lg))
            return logits

        with torch.no_grad():
            want = serve(fresh(), None)
            got = serve(shd.distribute_params(fresh(), mesh, cfg), mesh)
        out[f"{arch}/serve"] = [float((g - w).abs().max()) for g, w in zip(got, want)]
        out[f"{arch}/serve_ok"] = all(torch.allclose(g, w, rtol=1e-4, atol=1e-5)
                                      for g, w in zip(got, want))
    try:                      # 2 rows a device do not split into 4 microbatches
        sharded(4)
        out["refused"] = None
    except ValueError as e:
        out["refused"] = str(e)
    dist.destroy_process_group()
    print(json.dumps(out))
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    path = tmp_path_factory.mktemp("sharded_train") / "ranks.py"
    path.write_text(textwrap.dedent(_RANKS))
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), WORLD="4",
               PORT=str(_free_port()), OMP_NUM_THREADS="1", ARCHS=",".join(ARCHS))
    procs = [subprocess.Popen([sys.executable, str(path)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=dict(env, RANK=str(r)))
             for r in range(4)]
    outs = [p.communicate(timeout=600) for p in procs]
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, f"stdout:\n{o}\nstderr:\n{e[-6000:]}"
    return [json.loads(o.strip().splitlines()[-1]) for o, _ in outs]


@pytest.mark.parametrize("microbatches", MICROBATCHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_train_step_equals_unsharded_on_a_2x2_gloo_mesh(ranks, arch, microbatches):
    for rank, res in enumerate(ranks):
        rec = res[f"{arch}/{microbatches}"]
        loss, want = rec["loss"]
        assert abs(loss - want) <= 2e-5 + 2e-4 * abs(want), (rank, rec)
        assert not rec["bad_grads"], (rank, rec)
        assert not rec["bad_params"], (rank, rec)
        assert rec["ill"] < 1e-4 * rec["elements"], (rank, rec)
        assert rec == ranks[0][f"{arch}/{microbatches}"]      # every rank gathers the same


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_prefill_and_decode_equal_unsharded_on_a_2x2_gloo_mesh(ranks, arch):
    """Prefill of 24 tokens into a 48-slot cache (its positions over the
    model axis: the prompt's rows fall on one device, a decoded row on the
    other), then two decode steps: the logits within rtol 1e-4 / atol 1e-5
    of the unsharded run's (float32 sums in another order)."""
    for res in ranks:
        assert res[f"{arch}/serve_ok"], res[f"{arch}/serve"]


def test_sharded_microbatch_split_refuses_uneven_rows(ranks):
    """Batch 4 over a 2-way data axis leaves 2 rows a device: 4 microbatches
    would leave each empty (a step on nothing), so every rank refuses."""
    for res in ranks:
        assert res["refused"] and "4 equal microbatches" in res["refused"], res["refused"]
