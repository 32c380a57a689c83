"""Roofline terms from a counted dry run (counterpart of
``repro.roofline.analysis``; no card needed):

  compute term    = FLOPs per device / peak FLOP/s
  memory term     = bytes per device / HBM bandwidth
  collective term = collective result bytes per device / link bandwidth

The reference reads these from XLA's ``cost_analysis()`` and the compiled
HLO, both per device.  The port runs the step eagerly on meta tensors, as
DTensors on a mesh of a ``"fake"`` process group, under ``CostCounter``, a
dispatch mode that sees each device's **local** ops (the shards DTensor
computes on, after its redistributions), never the global op:

- FLOPs: the formulas of ``torch.utils.flop_counter`` (``FlopCounterMode``'s
  registry: matmuls, convolutions, attention), applied to the local shapes.
  Elementwise ops count no FLOPs, as in ``FlopCounterMode``.
- bytes: every local op's tensor inputs read once and outputs written once,
  views excluded.  This is unfused eager traffic, an upper bound on what
  XLA's ``bytes accessed`` counts after fusion.
- collectives: the ``_c10d_functional`` ops that DTensor's redistributions
  and explicit collectives issue, their result bytes per device summed by
  op (``collective_bytes``), under the reference's names ("all-gather",
  "all-reduce", "reduce-scatter", "all-to-all").  On a CPU mesh DTensor
  moves a shard from one dim to another by all-gather and chunk (gloo has
  no all-to-all), so there an "all-to-all" of NCCL counts as an all-gather.

Hardware model (NVIDIA H100 SXM, per card, data sheet): 989e12 FLOP/s bf16
dense on the tensor cores, 67e12 FLOP/s float32 on the CUDA cores, 3.35e12
B/s HBM3, and NVLink 4 at 450e9 B/s each way (900 GB/s both directions
together).  The collective term divides a device's result bytes by the
one-way rate, ``LINK_BW``.  Eight cards share an NVLink domain; a 256- or
512-card mesh spans many hosts, whose links between hosts are slower, so
there the collective term is a lower bound.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = ["PEAK_FLOPS", "PEAK_FLOPS_F32", "HBM_BW", "LINK_BW", "CostCounter",
           "collective_bytes", "RooflineTerms", "roofline", "model_flops_train",
           "model_flops_forward"]

PEAK_FLOPS = 989e12        # bf16 dense tensor cores, per card
PEAK_FLOPS_F32 = 67e12     # float32 outside the tensor cores
HBM_BW = 3.35e12           # B/s per card, HBM3
LINK_BW = 450e9            # B/s per card, NVLink 4, one direction

# the functional collectives DTensor and the explicit collectives issue,
# under the reference's HLO op names
_COLLECTIVE_NAMES = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast",
}
_NO_TRAFFIC = {"empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided",
               "wait_tensor", "lift_fresh", "_local_scalar_dense"}


def _tensors(tree):
    out = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            for y in x:
                walk(y)
        elif isinstance(x, dict):
            for y in x.values():
                walk(y)

    walk(tree)
    return out


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class CostCounter(TorchDispatchMode):
    """Counts one device's local program: FLOPs (total and by dtype), bytes
    and collective result bytes.

    An op on DTensors is let through (``NotImplemented``) so that DTensor
    runs it as local ops and collectives, which the mode then sees one by
    one; the ops DTensor runs on fake tensors to propagate shardings are
    skipped.  On plain tensors it counts what it is given, so a run with no
    mesh counts the single device's program."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.flops_by_dtype: Dict[str, float] = defaultdict(float)
        self.bytes = 0.0
        self.collectives: Dict[str, float] = defaultdict(float)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        from torch.utils.flop_counter import flop_registry

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if any(isinstance(t, FakeTensor) for t in ins + outs):
            return out
        packet = func._overloadpacket
        name = packet.__name__
        if name in _COLLECTIVE_NAMES and func.namespace.startswith("_c10d_functional"):
            self.collectives[_COLLECTIVE_NAMES[name]] += sum(map(_nbytes, outs))
            return out
        formula = flop_registry.get(packet)
        if formula is not None:
            f = float(formula(*args, **kwargs, out_val=out))
            self.flops += f
            self.flops_by_dtype[str(ins[0].dtype).replace("torch.", "")] += f
        rets = func._schema.returns
        alias = rets[0].alias_info if rets else None
        is_view = alias is not None and not alias.is_write
        if not is_view and name not in _NO_TRAFFIC:
            self.bytes += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        return out

    def add(self, other: "CostCounter", times: float = 1.0) -> "CostCounter":
        """Adds ``times`` × another counter's counts to this one's."""
        self.flops += times * other.flops
        self.bytes += times * other.bytes
        for k, v in other.flops_by_dtype.items():
            self.flops_by_dtype[k] += times * v
        for k, v in other.collectives.items():
            self.collectives[k] += times * v
        return self

    def cost(self) -> dict:
        """The counts under the reference's ``cost_analysis()`` keys."""
        return {"flops": self.flops, "bytes accessed": self.bytes}

    def compute_s(self) -> float:
        """FLOPs over the peak of their type: float32 at ``PEAK_FLOPS_F32``,
        every other type at ``PEAK_FLOPS``."""
        f32 = self.flops_by_dtype.get("float32", 0.0)
        return (self.flops - f32) / PEAK_FLOPS + f32 / PEAK_FLOPS_F32


def collective_bytes(counter: CostCounter) -> Dict[str, float]:
    """Result bytes per device of every collective a counted run issued, by
    op (the reference parses them from HLO text; the port records them)."""
    return dict(counter.collectives)


@dataclasses.dataclass
class RooflineTerms:
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    collectives: Dict[str, float]
    chips: int
    compute_s: float
    memory_s: float
    collective_s: float
    bottleneck: str
    model_flops: float = 0.0
    useful_flops_ratio: float = 0.0
    peak_flops: float = PEAK_FLOPS

    def as_dict(self):
        return dataclasses.asdict(self)


def roofline(cost: dict, collectives: Dict[str, float], chips: int,
             model_flops: float = 0.0, peak_flops: float = PEAK_FLOPS) -> RooflineTerms:
    """The three terms and the bottleneck from a cost dict ("flops",
    "bytes accessed") and the collective bytes, all per device."""
    flops = float(cost.get("flops", 0.0))
    bytes_accessed = float(cost.get("bytes accessed", 0.0))
    colls = dict(collectives)
    cbytes = float(sum(colls.values()))
    compute_s = flops / peak_flops
    memory_s = bytes_accessed / HBM_BW
    collective_s = cbytes / LINK_BW
    terms = {"compute": compute_s, "memory": memory_s, "collective": collective_s}
    bottleneck = max(terms, key=terms.get)
    total_flops = flops * chips
    return RooflineTerms(
        flops_per_device=flops,
        bytes_per_device=bytes_accessed,
        collective_bytes_per_device=cbytes,
        collectives=colls,
        chips=chips,
        compute_s=compute_s,
        memory_s=memory_s,
        collective_s=collective_s,
        bottleneck=bottleneck,
        model_flops=model_flops,
        useful_flops_ratio=(model_flops / total_flops) if total_flops else 0.0,
        peak_flops=peak_flops,
    )


def model_flops_train(cfg, tokens: int) -> float:
    """6·N·D (dense) or 6·N_active·D (MoE) for one train step over D=tokens."""
    return 6.0 * cfg.active_param_count() * tokens


def model_flops_forward(cfg, tokens: int) -> float:
    return 2.0 * cfg.active_param_count() * tokens
