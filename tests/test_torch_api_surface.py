"""Port parity, the public PPR serving API: ``repro_torch.ppr_serving``'s
names and signatures against the reference's checked-in manifest
(``tests/api_surface_ppr_serving.txt``, read only), and
``ShardedRegisteredGraph.sharded_quantized`` against the reference's.

The port's surface is built with the reference test's generator
(``tests/test_api_surface.py``: only ``inspect``, so the port's side needs no
JAX) over the ``repro_torch`` package.  The intended differences are mapped
before the comparison, and nothing else:

- every entry point takes ``device=`` (the port runs on the card unless
  asked for the CPU), a last parameter the reference lacks;
- ``Pallas*`` → ``Fused*`` (the family ``pallas`` → ``fused``), whose
  registered graph also exposes the pad-free dst stream it serves from
  (``fused_stream``, ``fused_dangling``) and whose engines annotate
  ``make_graph``'s ``mesh_axis`` as the other engines do;
- ``jnp.ndarray`` / ``Array`` → ``torch.Tensor`` / ``Tensor``;
- the registered graphs' ``apply_delta`` leaves ``delta`` unannotated (the
  port's ``EdgeDelta`` lives in ``graph_updates``, which imports the
  serving package), so ``delta``'s annotation is dropped on both sides.
"""
import inspect
import os
import re
import sys
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

import test_api_surface as ref_surface  # noqa: E402

MANIFEST = os.path.join(HERE, "api_surface_ppr_serving.txt")
PORT_ONLY_MEMBERS = {("FusedRegisteredGraph", "fused_dangling"),
                     ("FusedRegisteredGraph", "fused_stream")}


def _class_lines(name, cls, root):
    """``test_api_surface._class_lines`` with the package root as a parameter."""
    lines = [f"class {name}{ref_surface._sig(cls.__init__)}"]
    members = {}
    for klass in reversed(cls.__mro__):
        if klass.__module__.split(".")[0] != root:
            continue
        for attr, value in vars(klass).items():
            if not attr.startswith("_"):
                members[attr] = value
    for attr in sorted(members):
        if (name, attr) in PORT_ONLY_MEMBERS:
            continue
        value = members[attr]
        if isinstance(value, property):
            lines.append(f"  {attr}: property")
        elif isinstance(value, (classmethod, staticmethod)):
            lines.append(f"  {attr}{ref_surface._sig(value.__func__)} "
                         f"[{type(value).__name__}]")
        elif callable(value):
            lines.append(f"  {attr}{ref_surface._sig(value)}")
        else:
            lines.append(f"  {attr} = {value!r}")
    return lines


def _port_blocks():
    import repro_torch.ppr_serving as pkg

    blocks = {}
    for name in sorted(pkg.__all__):
        obj = getattr(pkg, name)
        if inspect.isclass(obj):
            blocks[name] = _class_lines(name, obj, "repro_torch")
        elif callable(obj):
            blocks[name] = [f"def {name}{ref_surface._sig(obj)}"]
        else:
            blocks[name] = [f"{name} = {obj!r}"]
    return blocks


def _strip_device(line: str) -> str:
    line = line.replace("delta: 'EdgeDelta'", "delta")
    return re.sub(r", device=(?:'cuda'|None)\)", ")", line)


def _reference_blocks():
    """The manifest's entries, by public name, with the intended renames."""
    with open(MANIFEST) as f:
        body = [ln for ln in f.read().splitlines() if ln and not ln.startswith("#")]
    blocks, name = {}, None
    for ln in body:
        if not ln.startswith("  "):
            name = re.match(r"(?:class |def )?(\w+)", ln).group(1)
            blocks[name] = []
        blocks[name].append(ln)
    out = {}
    for name, lines in blocks.items():
        new = name.replace("Pallas", "Fused")
        fixed = []
        for ln in lines:
            ln = ln.replace("Pallas", "Fused").replace("'pallas", "'fused")
            ln = ln.replace("jnp.ndarray", "torch.Tensor")
            ln = re.sub(r"\bArray\b", "Tensor", ln)
            ln = ln.replace("delta: 'EdgeDelta'", "delta")
            if name.startswith("Pallas") and "make_graph" in ln:
                ln = ln.replace("mesh_axis=None", "mesh_axis: 'Optional[str]' = None")
            fixed.append(ln)
        out[new] = fixed
    return out


def test_port_api_surface_matches_reference_manifest():
    want = _reference_blocks()
    got = {k: [_strip_device(ln) for ln in v] for k, v in _port_blocks().items()}
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name] == want[name], name


# ---------------------------------------------------------------------------
# F1: ShardedRegisteredGraph.sharded_quantized
# ---------------------------------------------------------------------------
jax = pytest.importorskip("jax")

from repro.core.coo import COOGraph  # noqa: E402
from repro.core.fixed_point import format_for_bits  # noqa: E402
from repro.core.spmv import partition_edges_by_dst  # noqa: E402
from repro.ppr_serving.graphs import ShardedRegisteredGraph as RSharded  # noqa: E402
from repro_torch.convert import graph_from_arrays, raw_to_numpy  # noqa: E402
from repro_torch.core.fixed_point import format_for_bits as tformat_for_bits  # noqa: E402
from repro_torch.launch.mesh import make_mesh  # noqa: E402
from repro_torch.ppr_serving import ShardedRegisteredGraph as TSharded  # noqa: E402


def _graph(v=641, e=2500, seed=0):
    rng = np.random.default_rng(seed)
    return COOGraph.from_edges(rng.integers(0, v - 40, e), rng.integers(0, v, e), v)


@pytest.mark.parametrize("s", [1, 3, 4])
def test_sharded_quantized_raw_bits_equal_reference(s):
    """Q1.25 (26 bits), V = 641: the port's partitioned raw values, on the
    controller, are the reference's ``sharded_quantized`` bit for bit (its
    graph on a stand-in mesh: it reads only ``shape`` and ``axis_names``),
    and its host partitioning of ``_quantize_host``."""
    g = _graph()
    fmt, tfmt = format_for_bits(26), tformat_for_bits(26)
    r = RSharded("g", g, types.SimpleNamespace(shape={"shard": s}, axis_names=("shard",)))
    want = np.asarray(r.sharded_quantized(fmt))
    _, _, host = partition_edges_by_dst(g.x, g.y, r._quantize_host(fmt), g.num_vertices, s,
                                        packet=r.packet)
    np.testing.assert_array_equal(want, host)
    t = TSharded("g", graph_from_arrays(g.x, g.y, g.val, g.dangling, g.num_vertices),
                 make_mesh((s,), ("shard",), device="cpu"), device="cpu")
    got = t.sharded_quantized(tfmt)
    assert got.dtype == torch.int32 and got.device == t.device
    assert got.shape == want.shape
    np.testing.assert_array_equal(raw_to_numpy(got), want.astype(np.uint32))
    assert t.sharded_quantized(tfmt) is got                      # cached


@pytest.mark.parametrize("s", [3, 4])
def test_sharded_quantized_is_built_on_demand_and_rebuilt_after_a_delta(s):
    """The serving path (``partition_format``, which every sharded engine's
    prepare and plan call) returns a host view of the partitioned raw bits
    and puts nothing on the controller; ``sharded_quantized`` builds the
    controller copy when asked, and after a delta rebuilds it, equal to the
    reference's after the same delta."""
    from repro.graph_updates import random_delta
    from repro.ppr_serving.engine import sharded as rsharded
    from repro_torch.graph_updates import EdgeDelta
    from repro_torch.ppr_serving.engine import sharded as tsharded

    g = _graph()
    fmt, tfmt = format_for_bits(26), tformat_for_bits(26)
    r = RSharded("g", g, types.SimpleNamespace(shape={"shard": s}, axis_names=("shard",)))
    t = TSharded("g", graph_from_arrays(g.x, g.y, g.val, g.dangling, g.num_vertices),
                 make_mesh((s,), ("shard",), device="cpu"), device="cpu")
    view = tsharded.partition_format(t, tfmt)
    assert not t._sharded_quantized                              # nothing uploaded
    assert np.shares_memory(view.numpy(), t._sharded_quant_host[tfmt])
    np.testing.assert_array_equal(raw_to_numpy(view), np.asarray(r.sharded_quantized(fmt)))
    before = t.sharded_quantized(tfmt)
    d = random_delta(g, np.random.default_rng(s), n_add=12, n_remove=5)
    rsharded.refresh_partition_after_delta(r, r.apply_delta(d))
    info = t.apply_delta(EdgeDelta(add_src=d.add_src, add_dst=d.add_dst,
                                   remove_src=d.remove_src, remove_dst=d.remove_dst,
                                   new_num_vertices=d.new_num_vertices))
    for _ in range(2):                          # both members armed: one refresh
        tsharded.refresh_partition_after_delta(t, info)
    after = t.sharded_quantized(tfmt)
    assert after is not before
    np.testing.assert_array_equal(raw_to_numpy(after),
                                  np.asarray(r.sharded_quantized(fmt)).astype(np.uint32))
