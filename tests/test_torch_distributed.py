"""Port parity, ``distributed/``: the sharding rules, the sharding hooks in
the models, the compressed all-reduce and the elastic restore.

- Placements: every parameter of all ten archs, at ``smoke_config`` size
  and at full size, on a (4, 2) and a (16, 16) mesh, against the
  reference's ``param_shardings`` axis by axis (the reference in a
  subprocess with 256 forced host devices, printing its specs as JSON;
  the port's per-layer tensors against the tail of the reference's stacked
  spec, whose stack dims must be unsharded).  Full size shows both MoE
  modes: mixtral's 8 experts take TP on 16 and EP on 2, moonshot's 64 take
  EP on both.  ``batch_shardings`` and ``cache_shardings`` the same way.
- The hooks: model outputs with no sharding context against the same
  model's parameters as DTensors under a context on a 1×1 gloo mesh, bit
  for bit.
- ``compressed_psum`` over a gloo group of 8 spawned CPU processes on the
  reference test's ``g`` (``tests/test_distributed.py``), 50 error-feedback
  steps, every step's mean and every residual bit-equal to the reference's
  run in its 8-device subprocess (the values sit on a 2^-8 grid, so the
  sums are exact), and within the reference's drift bound.
- ``restore(shardings=)`` over gloo groups of 4 spawned processes, from a
  (2, 2) mesh to a (4, 1) mesh: ``full_tensor()`` equal to the saved
  arrays and each rank's shard equal to its slice.  (The reference's own
  ``test_elastic_rescale_checkpoint`` fails on this host: no oracle.)
"""
import json
import os
import socket
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, list_archs, smoke_config  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.convert import lm_name_map  # noqa: E402
from repro_torch.distributed import sharding as tsh  # noqa: E402
from repro_torch.distributed.collectives import collective_bytes_saved  # noqa: E402
from repro_torch.launch import specs as tspecs  # noqa: E402
from repro_torch.models.transformer import Transformer, build_model  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "src")
MESHES = [(4, 2), (16, 16)]
SIZES = ["smoke", "full"]
SMALL = ShapeConfig("t", "train", 64, 32)


def _env(**extra):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC
    env.update(extra)
    return env


def _run_reference(script: str) -> str:
    out = subprocess.run([sys.executable, "-c", textwrap.dedent(script)], capture_output=True,
                         text=True, timeout=600,
                         env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=256",
                                  JAX_PLATFORMS="cpu"))
    assert out.returncode == 0, f"stdout:\n{out.stdout}\nstderr:\n{out.stderr}"
    return out.stdout


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(script: str, world: int, tmp_path) -> list:
    """``script`` in ``world`` processes joined by a gloo group (RANK, WORLD,
    PORT in the environment); each rank's last stdout line, parsed as JSON."""
    path = tmp_path / "ranks.py"
    path.write_text(textwrap.dedent(script))
    port = str(_free_port())
    procs = [subprocess.Popen([sys.executable, str(path)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True,
                              env=_env(RANK=str(r), WORLD=str(world), PORT=port,
                                       OMP_NUM_THREADS="1"))
             for r in range(world)]
    outs = [p.communicate(timeout=300) for p in procs]
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, f"stdout:\n{o}\nstderr:\n{e}"
    return [json.loads(o.strip().splitlines()[-1]) for o, _ in outs]


# ---------------------------------------------------------------------------
# placements against the reference's PartitionSpecs
# ---------------------------------------------------------------------------
_REF_SPECS = """
    import json, jax
    from repro.configs import get_config, list_archs, smoke_config
    from repro.configs.base import ShapeConfig
    from repro.models import build_model
    from repro.launch import specs as S
    from repro.distributed.sharding import (_path_str, batch_shardings, cache_shardings,
                                            param_shardings)

    def spec(s):
        return [list(e) if isinstance(e, tuple) else e for e in s.spec]

    def table(tree, shardings):
        leaves = jax.tree_util.tree_flatten_with_path(tree)[0]
        specs = jax.tree.leaves(shardings, is_leaf=lambda x: hasattr(x, "spec"))
        return {_path_str(p): {"shape": list(l.shape), "spec": spec(s)}
                for (p, l), s in zip(leaves, specs)}

    out = {}
    small = ShapeConfig("t", "train", 64, 32)
    for shape in [(4, 2), (16, 16)]:
        mesh = jax.make_mesh(shape, ("data", "model"))
        for arch in list_archs():
            for size in ("smoke", "full"):
                cfg = get_config(arch)
                cfg = smoke_config(cfg) if size == "smoke" else cfg
                api = build_model(cfg)
                ps = S.params_specs(api)
                rec = {"params": table(ps, param_shardings(ps, mesh, cfg=cfg))}
                if size == "smoke":
                    b = S.batch_specs(cfg, small)
                    rec["batch"] = table(b, batch_shardings(b, mesh))
                    c = S.cache_specs(api, 32, 64)
                    rec["cache"] = table(c, cache_shardings(c, mesh, 32))
                out[f"{shape[0]}x{shape[1]}/{arch}/{size}"] = rec
    print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def ref_specs():
    return json.loads(_run_reference(_REF_SPECS).strip().splitlines()[-1])


def _stub_mesh(shape):
    return types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": shape[0], "model": shape[1]})


def _norm(spec):
    """A spec as the reference's JSON prints it (``PartitionSpec`` writes a
    one-axis tuple as the axis)."""
    return [(e[0] if len(e) == 1 else list(e)) if isinstance(e, (tuple, list)) else e
            for e in spec]


def _nest(table):
    """{'segments/0/attn/wq': {...}} → nested dicts/lists of shape-only arrays."""
    root: dict = {}
    for path, rec in table.items():
        keys = path.split("/")
        node = root
        for k, nxt in zip(keys[:-1], keys[1:]):
            node = node.setdefault(k, {})
        node[keys[-1]] = np.broadcast_to(np.zeros((), bool), rec["shape"])

    def lists(node):
        if not isinstance(node, dict):
            return node
        if node and all(k.isdigit() for k in node):
            return [lists(node[str(i)]) for i in range(len(node))]
        return {k: lists(v) for k, v in node.items()}

    return lists(root)


@pytest.mark.parametrize("size", SIZES)
@pytest.mark.parametrize("mesh_shape", MESHES, ids=["4x2", "16x16"])
def test_param_placements_equal_reference(ref_specs, mesh_shape, size):
    mesh = _stub_mesh(mesh_shape)
    n_checked = 0
    for arch in list_archs():
        cfg = get_config(arch)
        cfg = smoke_config(cfg) if size == "smoke" else cfg
        ref = ref_specs[f"{mesh_shape[0]}x{mesh_shape[1]}/{arch}/{size}"]["params"]
        model = Transformer(cfg, None, torch.device("meta"))
        names = lm_name_map(_nest(ref), cfg)
        got = tsh.param_specs(model, mesh, cfg)
        assert sorted(got) == sorted(names), arch
        for name, (path, index) in names.items():
            want = ref["/".join(map(str, path))]["spec"]
            assert want[:len(index)] == [None] * len(index), (arch, name, want)
            assert _norm(got[name]) == want[len(index):], (arch, name, got[name], want)
            placements = tsh.placements(got[name], mesh)
            assert len(placements) == 2
            for axis, pl in zip(("data", "model"), placements):
                dims = [d for d, e in enumerate(got[name]) if axis in tsh._axes_of(e)]
                assert (pl.is_shard(dims[0]) if dims else pl.is_replicate()), (name, axis)
            n_checked += 1
    assert n_checked > 100


def test_moe_modes_at_full_size(ref_specs):
    """mixtral (E = 8) takes TP on a 16-way axis (d_ff sharded), EP on a
    2-way one; moonshot (E = 64) takes EP on both — as the reference."""
    for shape, arch, mode in [((16, 16), "mixtral-8x7b", "tp"), ((4, 2), "mixtral-8x7b", "ep"),
                              ((16, 16), "moonshot-v1-16b-a3b", "ep"),
                              ((4, 2), "moonshot-v1-16b-a3b", "ep")]:
        cfg = get_config(arch)
        got = tsh.param_specs(Transformer(cfg, None, torch.device("meta")), _stub_mesh(shape), cfg)
        wg = got["layers.0.moe.w_gate"]
        assert wg == ((None, None, "model") if mode == "tp" else ("model", None, None))
        ref = ref_specs[f"{shape[0]}x{shape[1]}/{arch}/full"]["params"]
        assert ref["segments/0/moe/w_gate"]["spec"][-3:] == _norm(wg)


@pytest.mark.parametrize("mesh_shape", MESHES, ids=["4x2", "16x16"])
def test_batch_and_cache_placements_equal_reference(ref_specs, mesh_shape):
    mesh = _stub_mesh(mesh_shape)
    for arch in list_archs():
        cfg = smoke_config(get_config(arch))
        ref = ref_specs[f"{mesh_shape[0]}x{mesh_shape[1]}/{arch}/smoke"]
        batch = tspecs.batch_specs(cfg, SMALL)
        got = tsh.batch_specs(batch, mesh)
        assert sorted(got) == sorted(ref["batch"]), arch
        for k, spec in got.items():
            assert _norm(spec) == ref["batch"][k]["spec"], (arch, k)
        api = build_model(cfg, device="meta")
        cache = tsh.cache_specs(tspecs.cache_specs(api, 32, 64), mesh, 32)
        want = {}
        for path, rec in ref["cache"].items():
            want.setdefault(path.split("/")[-1], []).append(rec)
        leaves = []
        tsh._map_tree(lambda p, s: leaves.append((p.split("/")[-1], s)), cache)
        assert leaves, arch
        for key, spec in leaves:
            for rec in want[key]:      # every stacked leaf of that name: same tail
                assert rec["spec"][:len(rec["spec"]) - len(spec)] == \
                    [None] * (len(rec["spec"]) - len(spec)), (arch, key)
                assert _norm(spec) == rec["spec"][-len(spec):], (arch, key, spec, rec)


def test_moe_mode_and_context_helpers():
    assert tsh.moe_mode(8) is None
    tsh.set_sharding_context(_stub_mesh((16, 16)))
    try:
        assert tsh.moe_mode(8) == "tp" and tsh.moe_mode(64) == "ep"
        assert tsh.batch_axes() == ("data",)
    finally:
        tsh.set_sharding_context(None)
    tsh.set_sharding_context(types.SimpleNamespace(axis_names=("pod", "data", "model"),
                                                   shape={"pod": 2, "data": 16, "model": 16}),
                             sequence_parallel=False)
    try:
        assert tsh.batch_axes() == ("pod", "data") and tsh._CTX["seq_axis"] is None
    finally:
        tsh.set_sharding_context(None)
    x = torch.ones(2, 3, 4)
    assert tsh.shard_activation(x) is x and tsh.constrain(x, ("data",)) is x
    assert tsh.shard_heads(x, 2) is x


def test_distribute_refuses_an_undivided_dim():
    """As ``jax.jit`` refuses an argument sharding the axis does not divide."""
    with pytest.raises(ValueError, match="not divisible by 16"):
        tsh._check_divisible((8, 4), (None, "model"), _stub_mesh((16, 16)), "x")
    tsh._check_divisible((8, 32), (("data",), "model"), _stub_mesh((4, 16)), "x")


def test_collective_bytes_saved_equals_reference_formula():
    assert collective_bytes_saved(10, 12) == 32.0 / 15.0
    assert collective_bytes_saved(10, 8, int_bits=3) == 32.0 / 12.0


# ---------------------------------------------------------------------------
# the hooks: no context = a 1×1 mesh, bit for bit
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def gloo_one():
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{_free_port()}",
                            rank=0, world_size=1)
    from repro_torch.launch.mesh import make_debug_mesh

    yield make_debug_mesh(1, 1, device_type="cpu")
    dist.destroy_process_group()


@pytest.mark.parametrize("arch", ["gemma-2b", "mixtral-8x7b", "mamba2-1.3b",
                                  "whisper-medium"])
def test_sharding_hooks_are_exact_on_a_one_device_mesh(gloo_one, arch):
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    cfg = smoke_config(get_config(arch))
    api = build_model(cfg, device="cpu", remat=False)
    params = api.init_params(torch.Generator().manual_seed(0))
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32),
             "targets": rng.integers(0, cfg.vocab_size, (2, 16)).astype(np.int32)}
    if cfg.enc_len:
        batch["frames"] = rng.standard_normal((2, cfg.enc_len, cfg.d_model)).astype(np.float32)
    want_logits = api.forward(params, batch)
    want_loss = api.loss_fn(params, batch)
    tsh.distribute_params(params, gloo_one, cfg)
    dbatch = {k: tsh.distribute(torch.as_tensor(v), gloo_one, (("data",),))
              for k, v in batch.items()}
    tsh.set_sharding_context(gloo_one)
    try:
        with implicit_replication():
            logits = api.forward(params, dbatch)
            loss = api.loss_fn(params, dbatch)
    finally:
        tsh.set_sharding_context(None)
    assert isinstance(logits, DTensor)
    torch.testing.assert_close(logits.full_tensor(), want_logits, rtol=0, atol=0)
    torch.testing.assert_close(loss.full_tensor(), want_loss, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# compressed_psum over 8 gloo ranks against the reference's 8 devices
# ---------------------------------------------------------------------------
_REF_PSUM = """
    import json, numpy as np, jax, jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from repro.compat import shard_map
    from repro.distributed.collectives import compressed_psum
    mesh = jax.make_mesh((8,), ("data",), devices=jax.devices()[:8])
    rng = np.random.default_rng(0)
    g = rng.standard_normal((8, 64)).astype(np.float32) * 0.1
    f = jax.jit(shard_map(lambda gs, rs: compressed_psum(gs, rs, "data", frac_bits=8),
                          mesh=mesh, in_specs=(P("data"), P("data")),
                          out_specs=(P("data"), P("data"))))
    r = jnp.zeros_like(jnp.asarray(g))
    reds, ress = [], []
    for _ in range(50):
        red, r = f(jnp.asarray(g), r)
        reds.append(np.asarray(red).view(np.int32).tolist())
        ress.append(np.asarray(r).view(np.int32).tolist())
    print(json.dumps({"red": reds, "res": ress}))
"""

_PORT_PSUM = """
    import json, os, numpy as np, torch, torch.distributed as dist
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD"])
    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:" + os.environ["PORT"],
                            rank=rank, world_size=world)
    from torch.distributed.device_mesh import init_device_mesh
    from repro_torch.distributed.collectives import (compressed_psum,
                                                     make_compressed_grad_allreduce)
    mesh = init_device_mesh("cpu", (world,), mesh_dim_names=("data",))
    rng = np.random.default_rng(0)
    g = rng.standard_normal((8, 64)).astype(np.float32) * 0.1
    mine = torch.from_numpy(g[rank:rank + 1].copy())
    r = torch.zeros_like(mine)
    reds, ress = [], []
    for _ in range(50):
        red, r = compressed_psum(mine, r, "data", frac_bits=8, mesh=mesh)
        reds.append(red.numpy().view(np.int32).tolist())
        ress.append(r.numpy().view(np.int32).tolist())
    allreduce = make_compressed_grad_allreduce(mesh, "data", frac_bits=8)
    grads = {"a": mine, "b": 3 * mine[:, :16]}
    res = {k: torch.full_like(v, 2.0 ** -10) for k, v in grads.items()}
    red_d, res_d = allreduce(grads, res)
    same = all(torch.equal(red_d[k], compressed_psum(grads[k], res[k], "data", 8, mesh=mesh)[0])
               and torch.equal(res_d[k], compressed_psum(grads[k], res[k], "data", 8,
                                                         mesh=mesh)[1]) for k in grads)
    dist.destroy_process_group()
    print(json.dumps({"red": reds, "res": ress, "dict_equal": same}))
"""


def test_compressed_psum_bit_equal_reference_over_8_gloo_ranks(tmp_path):
    ref = json.loads(_run_reference(_REF_PSUM).strip().splitlines()[-1])
    ranks = _run_ranks(_PORT_PSUM, 8, tmp_path)
    rng = np.random.default_rng(0)
    g = rng.standard_normal((8, 64)).astype(np.float32) * 0.1
    exact = g.mean(0)
    acc = np.zeros(64, np.float32)
    for step in range(50):
        for rank, got in enumerate(ranks):
            assert got["red"][step] == [ref["red"][step][rank]], (step, rank)
            assert got["res"][step] == [ref["res"][step][rank]], (step, rank)
        red = np.asarray(ranks[0]["red"][step], np.int32).view(np.float32)[0]
        if step == 0:
            assert np.abs(red - exact).max() <= 2.0 ** -8 + 1e-6
        acc += red
    assert np.abs(acc - 50 * exact).max() <= 2.0 ** -8 * 2   # the reference's drift bound
    assert all(r["dict_equal"] for r in ranks)


# ---------------------------------------------------------------------------
# restore(shardings=): (2, 2) → (4, 1) over 4 gloo ranks
# ---------------------------------------------------------------------------
_PORT_RESTORE = """
    import json, os, numpy as np, torch, torch.distributed as dist
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD"])
    dist.init_process_group("gloo", init_method="tcp://127.0.0.1:" + os.environ["PORT"],
                            rank=rank, world_size=world)
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from repro_torch.launch.mesh import make_debug_mesh
    from repro_torch.training import checkpoint as ckpt
    ckpt_dir = os.environ["CKPT"]
    old = make_debug_mesh(2, 2, device_type="cpu")
    g = torch.Generator().manual_seed(0)
    full = {"w": torch.randn(8, 12, generator=g), "b": torch.randn(12, generator=g),
            "step": torch.tensor(7, dtype=torch.int32)}
    layout = {"w": [Shard(0), Shard(1)], "b": [Replicate(), Shard(0)], "step": None}
    state = {k: v if layout[k] is None else distribute_tensor(v, old, layout[k])
             for k, v in full.items()}
    host = {k: (v.full_tensor() if layout[k] else v) for k, v in state.items()}
    if rank == 0:
        ckpt.save(ckpt_dir, 3, host)
    dist.barrier()
    new = make_debug_mesh(4, 1, device_type="cpu")
    like = {k: torch.zeros_like(v) for k, v in full.items()}
    shardings = {"w": (new, [Shard(0), Replicate()]), "b": (new, [Shard(0), Replicate()]),
                 "step": None}
    got = ckpt.restore(ckpt_dir, 3, like, shardings=shardings)
    ok = {
        "w_full": torch.equal(got["w"].full_tensor(), full["w"]),
        "w_local": torch.equal(got["w"].to_local(), full["w"][2 * rank:2 * rank + 2]),
        "b_full": torch.equal(got["b"].full_tensor(), full["b"]),
        "b_local": torch.equal(got["b"].to_local(), full["b"][3 * rank:3 * rank + 3]),
        "step": torch.equal(got["step"], full["step"]),
        "placements": [str(p) for p in got["w"].placements],
    }
    dist.destroy_process_group()
    print(json.dumps(ok))
"""


def test_restore_with_shardings_reshards_2x2_to_4x1_over_4_gloo_ranks(tmp_path, monkeypatch):
    monkeypatch.setenv("CKPT", str(tmp_path / "ckpt"))
    ranks = _run_ranks(_PORT_RESTORE, 4, tmp_path)
    for r in ranks:
        assert all(r[k] for k in ("w_full", "w_local", "b_full", "b_local", "step")), r
        assert r["placements"] in (["Shard(dim=0)", "Replicate()"], ["S(0)", "R"])
