"""Logical-axis sharding rules → DTensor placements (counterpart of
``repro.distributed.sharding``).

The rules are the reference's: path patterns over the parameter names, a
spec per tensor dim naming the mesh axis that shards it (``"model"``, a
tuple such as ``("pod", "data")``, or ``None``).  A spec becomes one
placement per mesh axis, ``Shard(d)`` for the axis that names dim ``d`` and
``Replicate()`` for the others (``placements``), over a
``torch.distributed.device_mesh.DeviceMesh`` with the reference's axis
names: ("data", "model") single-pod, ("pod", "data", "model") multi-pod.
"data" composes with "pod" for batch parallelism, pod-major.

The port's parameters are one tensor per layer (``layers.3.attn.wq``),
where the reference stacks a segment's layers in leading ``[reps, g]``
dims that its rules leave unsharded; so only the spec's tail applies here.
Names are matched with ``/`` for ``.``, so the reference's patterns read
them as they are.

An optional sharding context lets the models pin activations:
``shard_activation`` at layer boundaries (sequence parallelism),
``constrain`` inside MoE dispatch, the MLP and mamba's projections,
``shard_heads`` around each split into heads and merge of them,
``local_region`` for the regions that are one device's program (MoE
dispatch and combine, the SSD scan, attention over a device's own query
positions), ``vocab_rows`` for the embedding lookup and
``write_positions`` for cache writes.  Each returns its input (or
function, or does the plain write) when no context is set, so an
unsharded run computes the same bits as before.  Under a context a DTensor is
redistributed (``DTensor.redistribute``), a plain tensor is distributed
(``distribute_tensor``), a region runs under ``local_map``.

As under ``jax.jit``, a parameter, batch or cache dim that its mesh axes do
not divide is refused (``distribute``), not padded.
"""
from __future__ import annotations

import re
from typing import Any, Dict, Iterable, Mapping, Optional, Sequence, Tuple

import torch

__all__ = ["set_sharding_context", "shard_activation", "constrain", "batch_axes",
           "moe_mode", "shard_heads", "heads_layout", "model_start", "model_if_divides",
           "local_region", "vocab_rows", "write_positions", "axis_sizes", "placements", "layout", "distribute", "param_specs", "param_shardings",
           "distribute_params", "distribute_tree", "batch_specs", "batch_shardings",
           "cache_specs", "cache_shardings", "Spec"]

Spec = Tuple[Any, ...]        # per tensor dim: None, an axis name, or a tuple of names


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------
def axis_sizes(mesh) -> Dict[str, int]:
    """axis name → size, in mesh order, of a ``DeviceMesh`` or of any object
    with ``axis_names`` and a ``shape`` mapping (as a ``jax.sharding.Mesh``)."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.shape))
    return {a: int(mesh.shape[a]) for a in mesh.axis_names}


def _axes_of(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def placements(spec: Spec, mesh) -> tuple:
    """One placement per mesh axis for a tensor laid out by ``spec``."""
    from torch.distributed.tensor import Replicate, Shard

    out = {a: Replicate() for a in axis_sizes(mesh)}
    for dim, entry in enumerate(spec):
        for a in _axes_of(entry):
            out[a] = Shard(dim)
    return tuple(out.values())


def layout(spec: Spec, mesh):
    """(the mesh a DTensor lives on, its placements) for ``spec``.

    On a multi-pod mesh the rules shard "pod" and "data" only together
    (the batch, pod-major), so DTensors live on the same ranks as a 2-d
    mesh ("pod+data", "model"): the same layout, which keeps DTensor's
    redistribution planner off its search over several mesh dims sharding
    one tensor dim (minutes a cell)."""
    sizes = axis_sizes(mesh)
    # an axis of one device shards nothing (and DTensor then has no sharded
    # dims to flatten, which torch before 2.13 cannot do with two of them)
    spec = tuple(tuple(a for a in _axes_of(e) if sizes[a] > 1) or None for e in spec)
    names = tuple(sizes)
    if names != ("pod", "data", "model"):
        return mesh, placements(spec, mesh)
    from torch.distributed.device_mesh import DeviceMesh

    flat = getattr(mesh, "_pod_data_model", None)   # built once a mesh
    if flat is None:
        flat = DeviceMesh(mesh.device_type, mesh.mesh.reshape(-1, mesh.mesh.shape[-1]),
                          mesh_dim_names=("pod+data", "model"))
        mesh._pod_data_model = flat
    merged = []
    for entry in spec:
        axes = set(_axes_of(entry))
        if axes & {"pod", "data"} and not {"pod", "data"} <= axes:
            raise ValueError(f"spec {spec}: on a multi-pod mesh 'pod' and 'data' "
                             f"shard together")
        merged.append(("pod+data",) * ("data" in axes) + ("model",) * ("model" in axes)
                      or None)
    return flat, placements(tuple(merged), flat)


def _check_divisible(shape: Sequence[int], spec: Spec, mesh, what: str):
    sizes = axis_sizes(mesh)
    for dim, entry in enumerate(spec):
        n = 1
        for a in _axes_of(entry):
            n *= sizes[a]
        if shape[dim] % n:
            raise ValueError(
                f"{what}: dim {dim} of size {shape[dim]} is not divisible by {n} "
                f"(spec {spec} on mesh {sizes})")


def distribute(t: torch.Tensor, mesh, spec: Spec, what: str = "tensor"):
    """``t`` as a DTensor laid out by ``spec``; refuses a dim that its axes do
    not divide, as ``jax.jit`` refuses such an argument sharding."""
    from torch.distributed.tensor import distribute_tensor

    _check_divisible(t.shape, spec, mesh, what)
    return distribute_tensor(t, *layout(spec, mesh))


# ---------------------------------------------------------------------------
# global sharding context (set by the drivers; no-op when unset)
# ---------------------------------------------------------------------------
_CTX: dict = {"mesh": None, "batch_axes": None, "seq_axis": None}


def set_sharding_context(mesh, *, sequence_parallel: bool = True):
    if mesh is None:
        _CTX.update(mesh=None, batch_axes=None, seq_axis=None)
        return
    names = axis_sizes(mesh)
    batch = tuple(a for a in ("pod", "data") if a in names)
    _CTX.update(
        mesh=mesh,
        batch_axes=batch if batch else None,
        seq_axis="model" if sequence_parallel and "model" in names else None,
    )


class _Pin(torch.autograd.Function):
    """A redistribute that also pins the gradient: backward brings it to the
    input's placements, even where the forward moved nothing.  (A DTensor's
    gradient takes whatever layout the op after it gives; a view's backward
    needs the layout its forward saw.)"""

    @staticmethod
    def forward(ctx, x, mesh, want):
        from torch.distributed.tensor import Replicate

        # the gradient of a pending sum is the same on every device
        ctx.mesh = mesh
        ctx.src = tuple(Replicate() if p.is_partial() else p for p in x.placements)
        return x.redistribute(mesh, want)

    @staticmethod
    def backward(ctx, g):
        return g.redistribute(ctx.mesh, ctx.src), None, None


def constrain(x, spec: Spec):
    """``x`` laid out by ``spec`` on the context's mesh (no-op unset); its
    gradient is pinned too.  A spec shorter than ``x`` leaves the trailing
    dims unsharded."""
    mesh = _CTX["mesh"]
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor, distribute_tensor

    mesh, want = layout(tuple(spec) + (None,) * (x.ndim - len(spec)), mesh)
    if not isinstance(x, DTensor):
        return distribute_tensor(x, mesh, want)
    if x.requires_grad and torch.is_grad_enabled():
        return _Pin.apply(x, mesh, want)
    return x if tuple(x.placements) == want else x.redistribute(mesh, want)


def shard_activation(x, kind: str = "residual"):
    """[B, S, D] activations: batch → (pod, data), seq → model (SP)."""
    if _CTX["mesh"] is None:
        return x
    return constrain(x, (_CTX["batch_axes"], _CTX["seq_axis"], None))


def batch_axes(batch: Optional[int] = None):
    """The context's batch axes; with ``batch``, None unless they divide it."""
    axes = _CTX["batch_axes"]
    if axes is None or batch is None:
        return axes
    sizes = axis_sizes(_CTX["mesh"])
    n = 1
    for a in axes:
        n *= sizes[a]
    return axes if batch % n == 0 else None


def shard_heads(x, heads: int):
    """Attention tensors around a split into heads or a merge of them: a
    [B, S, heads·…] projection, or a [B, S, H, …] tensor with its heads in
    dim 2, where ``heads`` is the count that must stay whole on a device
    (the kv heads: queries are split into kv groups).  Heads → "model"
    when ``heads`` divides it, else positions → "model" when they divide
    it, else whole on every device of the model axis; the batch over the
    data axes where they divide it.  (XLA splits a head across devices; a
    DTensor dim cannot be split into two sharded dims, so the port pins, on
    both sides of each split and merge and after rope, a layout the
    reshapes keep.)  No-op unset."""
    mesh = _CTX["mesh"]
    if mesh is None:
        return x
    dp = batch_axes(x.shape[0])
    return constrain(x, {"heads": (dp, None, "model"), "positions": (dp, "model"),
                         None: (dp,)}[heads_layout(heads, x.shape[1])])


def heads_layout(heads: int, positions: int) -> Optional[str]:
    """What ``shard_heads`` lays over the model axis: "heads", "positions"
    or None (no context, a one-device axis, or neither divides)."""
    mesh = _CTX["mesh"]
    m = 1 if mesh is None else axis_sizes(mesh).get("model", 1)
    if m > 1 and heads % m == 0:
        return "heads"
    if m > 1 and positions % m == 0:
        return "positions"
    return None


def model_start(n: int) -> int:
    """The first of this device's ``n / m`` positions along the model axis
    (0 with no context)."""
    mesh = _CTX["mesh"]
    if mesh is None:
        return 0
    flat = layout((), mesh)[0]
    axis = flat.mesh_dim_names.index("model")
    return flat.get_coordinate()[axis] * (n // flat.size(axis))


def model_if_divides(n: int) -> Optional[str]:
    """"model" when the context's model axis divides ``n``, else None."""
    mesh = _CTX["mesh"]
    if mesh is None or n % axis_sizes(mesh).get("model", 1):
        return None
    return "model" if "model" in axis_sizes(mesh) else None


def local_region(fn, in_specs, out_specs, partial_grads: Optional[Mapping[int, Any]] = None):
    """``fn`` run as each device's own program on its local shards
    (``local_map``) under the context's mesh; ``fn`` itself when no context
    is set.  ``in_specs`` has a spec per argument (``None`` for a
    non-tensor); ``out_specs`` is one spec, or a list with one per output.
    Inputs are redistributed to their specs first.  ``partial_grads`` maps
    an argument to the mesh axes over which it is whole while the program
    uses only each device's part of it (its heads, its batch rows): each
    device's gradient is then its share of a sum over those axes, and is
    declared so."""
    mesh = _CTX["mesh"]
    if mesh is None:
        return fn
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    flat = layout((), mesh)[0]
    names = flat.mesh_dim_names

    def pl(spec):
        return None if spec is None else layout(spec, mesh)[1]

    def grad_pl(i, spec):
        out = pl(spec)
        axes = _axes_of((partial_grads or {}).get(i))
        if spec is None or not axes:
            return out
        out = list(out)
        for a in axes:
            d = names.index(a if a in names else "pod+data")
            if flat.size(d) > 1:          # one device holds the whole sum
                out[d] = Partial()
        return tuple(out)

    outs = tuple(pl(s) for s in out_specs) if isinstance(out_specs, list) else (pl(out_specs),)
    return local_map(fn, out_placements=outs, in_placements=tuple(pl(s) for s in in_specs),
                     in_grad_placements=tuple(grad_pl(i, s) for i, s in enumerate(in_specs)),
                     device_mesh=flat, redistribute_inputs=True)


def vocab_rows(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` for ids [B, S].  Under a context, a table that the mesh
    shards is read by an ``embedding`` lookup, which DTensor runs as each
    device's masked lookup of its own rows and a pending sum over the model
    axis, as XLA partitions the reference's gather: the table is never
    gathered.  The sum is reduced at once into ``shard_activation``'s
    layout (a reduce-scatter under sequence parallelism; DTensor can reduce
    a masked sum only once, so it must not reach two consumers)."""
    if _CTX["mesh"] is not None:
        from torch.distributed.tensor import DTensor

        if isinstance(table, DTensor) and any(p.is_shard() for p in table.placements):
            return shard_activation(torch.nn.functional.embedding(ids, table))
    return table[ids]


def write_positions(cache: torch.Tensor, start: int, rows: torch.Tensor) -> torch.Tensor:
    """``cache[:, start:start + rows.shape[1]] = rows`` in place (cast to the
    cache's dtype); returns ``cache``.  A DTensor cache sharded over its
    positions is never gathered: rows that fill it are laid out as it is,
    and fewer rows are written by each device into the part of its own
    positions they cover."""
    from torch.distributed.tensor import DTensor, Replicate, distribute_tensor

    n = rows.shape[1]
    if not isinstance(cache, DTensor):
        cache[:, start:start + n] = rows.to(cache.dtype)
        return cache
    mesh, pls = cache.device_mesh, tuple(cache.placements)
    fill = start == 0 and n == cache.shape[1]
    want = pls if fill else tuple(Replicate() if p.is_shard(1) else p for p in pls)
    rows = (rows.redistribute(mesh, want) if isinstance(rows, DTensor)
            else distribute_tensor(rows, mesh, want))
    local, mine = cache.to_local(), rows.to_local().to(cache.dtype)
    if fill:
        local.copy_(mine)
        return cache
    lo, size = 0, cache.shape[1]          # this device's positions [lo, lo + size)
    coord = mesh.get_coordinate()
    for axis, p in enumerate(pls):
        if p.is_shard(1):
            size //= mesh.size(axis)
            lo += coord[axis] * size
    a, b = max(start, lo), min(start + n, lo + size)
    if a < b:
        local[:, a - lo:b - lo] = mine[:, a - start:b - start]
    return cache


def moe_mode(num_experts: int) -> Optional[str]:
    """'ep' when experts divide the model axis, else 'tp' (shard d_ff)."""
    mesh = _CTX["mesh"]
    if mesh is None or "model" not in axis_sizes(mesh):
        return None
    m = axis_sizes(mesh)["model"]
    return "ep" if num_experts % m == 0 else "tp"


# ---------------------------------------------------------------------------
# parameter shardings (path-pattern rules, the reference's)
# ---------------------------------------------------------------------------
# (regex over the name with "/" for ".", spec applied to the LAST dims)
_PARAM_RULES = [
    (r"embed$", ("model", None)),                  # vocab-sharded table
    (r"unembed$", (None, "model")),
    (r"pos_embed$|enc_pos$", (None, None)),
    (r"patch_proj$", (None, None)),
    # attention projections
    (r"(attn|cross)/wq$", (None, "model")),
    (r"(attn|cross)/wk$", (None, "model")),
    (r"(attn|cross)/wv$", (None, "model")),
    (r"(attn|cross)/wo$", ("model", None)),
    (r"(attn|cross)/(q_norm|k_norm)$", (None,)),
    # dense MLP
    (r"mlp/w_gate$|mlp/w_up$|mlp/w_fc$", (None, "model")),
    (r"mlp/w_down$|mlp/w_proj$", ("model", None)),
    (r"mlp/b_fc$", ("model",)),
    (r"mlp/b_proj$", (None,)),
    # MoE (expert parallelism over "model")
    (r"moe/router$", (None, None)),
    (r"moe/w_gate$|moe/w_up$", ("model", None, None)),
    (r"moe/w_down$", ("model", None, None)),
    # mamba2
    (r"mamba/w_in$", (None, "model")),
    (r"mamba/conv_w$", (None, "model")),
    (r"mamba/conv_b$", ("model",)),
    (r"mamba/(A_log|D|dt_bias)$", ("model",)),
    (r"mamba/norm_w$", ("model",)),
    (r"mamba/w_out$", ("model", None)),
    # norms & everything else: replicated
    (r".*", ()),
]


def _spec_for(path_s: str, ndim: int) -> Spec:
    for pat, spec in _PARAM_RULES:
        if re.search(pat, path_s):
            tail = tuple(spec)
            if len(tail) > ndim:  # scalar-ish params
                tail = tail[-ndim:] if ndim else ()
            return (None,) * (ndim - len(tail)) + tail
    return (None,) * ndim


def _named(params) -> Iterable[Tuple[str, torch.Tensor]]:
    if isinstance(params, torch.nn.Module):
        return params.named_parameters()
    return params.items()


def param_specs(params, mesh, cfg=None) -> Dict[str, Spec]:
    """name → spec for a ``Transformer`` (or a dict of tensors).

    The MoE rule is config-dependent: experts → "model" (EP) when
    num_experts divides the model axis; otherwise TP inside each expert
    (shard d_ff), e.g. mixtral E = 8 on a 16-way axis."""
    model_size = axis_sizes(mesh).get("model", 1)
    moe_tp = bool(cfg and cfg.num_experts and cfg.num_experts % model_size != 0)
    out = {}
    for name, t in _named(params):
        ps = name.replace(".", "/")
        nd = t.ndim
        if moe_tp and re.search(r"moe/(w_gate|w_up)$", ps):
            out[name] = (None,) * (nd - 1) + ("model",)                    # F
        elif moe_tp and re.search(r"moe/w_down$", ps):
            spec = [None] * nd
            spec[-2] = "model"                                              # F
            out[name] = tuple(spec)
        else:
            out[name] = _spec_for(ps, nd)
    return out


def param_shardings(params, mesh, cfg=None) -> Dict[str, tuple]:
    """name → placements (one per mesh axis) under the parameter rules."""
    return {k: placements(s, mesh) for k, s in param_specs(params, mesh, cfg).items()}


def distribute_params(module: torch.nn.Module, mesh, cfg=None) -> torch.nn.Module:
    """Every parameter of ``module`` replaced, in place, by a DTensor laid out
    by the parameter rules (``requires_grad`` kept).  Returns ``module``."""
    specs = param_specs(module, mesh, cfg)
    with torch.no_grad():
        for name, p in list(module.named_parameters()):
            owner, _, leaf = name.rpartition(".")
            setattr(module.get_submodule(owner), leaf,
                    torch.nn.Parameter(distribute(p.data, mesh, specs[name], name),
                                       requires_grad=p.requires_grad))
    return module


def distribute_tree(tree, specs, mesh, prefix: str = ""):
    """A nest of dicts and lists of tensors, each distributed by the spec at
    the same place in ``specs`` (``batch_specs`` / ``cache_specs``)."""
    if isinstance(tree, Mapping):
        return {k: distribute_tree(v, specs[k], mesh, f"{prefix}/{k}") for k, v in tree.items()}
    if isinstance(tree, list):
        return [distribute_tree(v, s, mesh, f"{prefix}/{i}")
                for i, (v, s) in enumerate(zip(tree, specs))]
    return distribute(tree, mesh, specs, prefix.lstrip("/"))


# ---------------------------------------------------------------------------
# batch / cache shardings
# ---------------------------------------------------------------------------
def _batch_axes(mesh):
    axes = tuple(a for a in ("pod", "data") if a in axis_sizes(mesh))
    return axes if axes else None


def _map_tree(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over a nest of dicts and lists (a tuple is a leaf)."""
    if isinstance(tree, Mapping):
        return {k: _map_tree(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_tree(fn, v, f"{prefix}/{i}" if prefix else str(i))
                for i, v in enumerate(tree)]
    return fn(prefix, tree)


def batch_specs(batch, mesh, batch_divisible: bool = True):
    """tokens/targets [B, S] → batch over (pod, data); stub embeddings
    likewise.  Same nesting as ``batch``, each tensor replaced by its spec."""
    dp = _batch_axes(mesh) if batch_divisible else None

    def one(_, leaf):
        nd = len(leaf.shape)
        return () if nd == 0 else (dp,) + (None,) * (nd - 1)

    return _map_tree(one, batch)


def batch_shardings(batch, mesh, batch_divisible: bool = True):
    return _map_tree(lambda _, s: placements(s, mesh),
                     batch_specs(batch, mesh, batch_divisible))


def cache_specs(cache, mesh, batch: int):
    """Decode cache rule: batch → (pod, data) when divisible, cache sequence
    → "model" (a rule that works for every kv_heads count, MQA's kv = 1
    included); whisper's cross cache shards kv-heads instead (enc_len 1500
    does not divide the axis).  Same nesting as ``cache``."""
    sizes = axis_sizes(mesh)
    dp = _batch_axes(mesh)
    n_dp = 1
    for a in (dp or ()):
        n_dp *= sizes[a]
    dp = dp if (dp and batch % n_dp == 0) else None
    model_size = sizes.get("model", 1)

    def one(path, leaf):
        nd = len(leaf.shape)
        if re.search(r"(^|/)(ck|cv)$", path) and nd >= 4:
            spec = [None] * nd                       # [..., B, enc, KV, hd]
            spec[-4] = dp
            spec[-2] = "model" if leaf.shape[-2] % model_size == 0 else None
            return tuple(spec)
        if re.search(r"(^|/)(k|v)$", path) and nd >= 4:
            spec = [None] * nd                       # [..., B, S, KV, hd]
            spec[-4] = dp
            spec[-3] = "model"
            return tuple(spec)
        if path.endswith("conv") and nd == 3:        # [B, K-1, conv_dim]
            return (dp, None, "model")
        if path.endswith("ssd") and nd == 4:         # [B, nh, hd, state]
            return (dp, "model", None, None)
        return (None,) * nd

    return _map_tree(one, cache)


def cache_shardings(cache, mesh, batch: int):
    return _map_tree(lambda _, s: placements(s, mesh), cache_specs(cache, mesh, batch))
