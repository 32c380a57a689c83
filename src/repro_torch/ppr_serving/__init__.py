"""PPR recommendation serving (counterpart of ``repro.ppr_serving``).

``PPRService`` admits queries into κ-batched waves on a registered graph and
serves ranked, self-excluding top-K ``Recommendation``s through futures;
``precision="auto"`` resolves through the adaptive-precision controller and
``prefetch=`` warms the result cache on idle polls; ``tracing=``/``slo=``/
``otlp=`` arm the observability layer, and ``PPRHTTPServer`` serves the
futures API over asyncio HTTP (``repro_torch.ppr_serving.http``).  A
graph registers onto an engine family: "single" (plain PyTorch), "fused"
(the hand-written fused-iteration CUDA kernel; its plain version on the CPU)
or, given ``mesh=`` (``repro_torch.launch.mesh.make_mesh``), "sharded"
(dst-range shards, each through the streaming SpMV kernel).  Everything
runs on the service's ``device`` ("cuda" unless the caller asks for the
CPU); a meshed graph's shards run on the mesh's devices of that type.
"""
from repro_torch.ppr_serving.cache import LRUCache
from repro_torch.ppr_serving.engine import (
    FixedEngine,
    FloatEngine,
    FusedFixedEngine,
    FusedFloatEngine,
    FusedRegisteredGraph,
    ShardedFixedEngine,
    ShardedFloatEngine,
    ShardedRegisteredGraph,
    WaveEngine,
    WavePlan,
    engine_families,
    engine_for,
    engine_names,
    family_members,
    get_engine,
    register_engine,
)
from repro_torch.ppr_serving.futures import PPRFuture, QueryRejected
from repro_torch.ppr_serving.graphs import RegisteredGraph
from repro_torch.ppr_serving.http import (
    AdmissionConfig,
    AdmissionController,
    PPRHTTPServer,
    ServingApp,
    WavePump,
)
from repro_torch.ppr_serving.prefetch import PrefetchConfig, Prefetcher
from repro_torch.ppr_serving.scheduler import Wave, WaveScheduler
from repro_torch.ppr_serving.service import (
    AUTO_KEY,
    FLOAT_KEY,
    PPRQuery,
    PPRService,
    Recommendation,
    normalize_precision,
    precision_key,
)
from repro_torch.ppr_serving.telemetry import SINGLE_DEVICE_KEY, ServiceTelemetry
from repro_torch.ppr_serving.topk import topk_dense, topk_streaming

__all__ = [
    "PPRService", "PPRQuery", "Recommendation", "PPRFuture", "QueryRejected",
    "RegisteredGraph", "FusedRegisteredGraph", "ShardedRegisteredGraph",
    "WaveEngine", "WavePlan",
    "register_engine", "get_engine", "engine_for", "family_members",
    "engine_names", "engine_families",
    "FloatEngine", "FixedEngine", "FusedFloatEngine", "FusedFixedEngine",
    "ShardedFloatEngine", "ShardedFixedEngine",
    "normalize_precision", "precision_key", "AUTO_KEY", "FLOAT_KEY",
    "SINGLE_DEVICE_KEY",
    "WaveScheduler", "Wave",
    "LRUCache", "ServiceTelemetry",
    "PrefetchConfig", "Prefetcher",
    "PPRHTTPServer", "ServingApp", "AdmissionConfig", "AdmissionController",
    "WavePump",
    "topk_dense", "topk_streaming",
]
