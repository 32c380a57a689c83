"""Engine backends — the pluggable datapath layer behind `PPRService`
(counterpart of ``repro.ppr_serving.engine``).

``WaveEngine.plan(graph, fmt) -> WavePlan`` binds a wave to device state: the
personalization-matrix builder, the one-iteration step over the engine's
device arrays, the iterate driver (fixed budget or early-exit), and the top-K
reduction.  Engines register by name into *families* with one float and one
fixed member: "single" (plain PyTorch over the full edge stream), "fused"
(the hand-written fused-iteration kernel, the reference's "pallas") and
"sharded" (dst-range shards over a ``launch.mesh.Mesh``, each shard's SpMV
through the hand-written streaming SpMV kernel).
"""
from repro_torch.ppr_serving.engine.base import (
    WaveEngine,
    WavePlan,
    engine_families,
    engine_for,
    engine_names,
    family_members,
    get_engine,
    register_engine,
)
from repro_torch.ppr_serving.engine.single import FixedEngine, FloatEngine
from repro_torch.ppr_serving.engine.fused import (
    FusedFixedEngine,
    FusedFloatEngine,
    FusedRegisteredGraph,
)
from repro_torch.ppr_serving.engine.sharded import ShardedFixedEngine, ShardedFloatEngine
from repro_torch.ppr_serving.graphs import ShardedRegisteredGraph

__all__ = [
    "WaveEngine", "WavePlan",
    "register_engine", "get_engine", "engine_for", "family_members",
    "engine_names", "engine_families",
    "FloatEngine", "FixedEngine",
    "FusedFloatEngine", "FusedFixedEngine", "FusedRegisteredGraph",
    "ShardedFloatEngine", "ShardedFixedEngine", "ShardedRegisteredGraph",
]
