"""Dynamic graph updates — epoch-versioned edge-delta ingestion for a live
``PPRService`` (counterpart of ``repro.graph_updates``).

``delta.py``      ``EdgeDelta``: batched add/remove edge lists + vertex
                  growth, with ``affected_frontier`` (touched vertices plus
                  their in-neighbors — the scoped-invalidation surface),
                  ``random_delta`` and ``localized_delta`` for benchmarks and
                  replay.  The host-side merge itself is
                  ``repro_torch.core.coo.merge_edge_delta``: the merged arrays
                  are bit-identical to a from-scratch ``from_edges`` build,
                  but only touched sources are renormalized, and the returned
                  ``EdgeMergeInfo`` lets registered graphs requantize only
                  changed ``val`` entries and re-packetize only the dirty dst
                  blocks of the fused layout.
``warmstart.py``  ``WarmStartStore``: bounded per-graph LRU of last-converged
                  PPR columns.  Waves seed ``V0`` from the stored column per
                  personalization vertex, so the early exit stops in far
                  fewer iterations after a delta.

Service integration (``repro_torch.ppr_serving.service``):
``PPRService.apply_delta`` bumps the graph's epoch (epoch-tagging cache keys
and wave keys), refreshes the armed engines' device state (on the fused
family: the dirty blocks re-packetized and a new dst stream uploaded), drops
only cache entries / pending queries whose personalization vertex falls in
the delta's affected frontier — everything else is retagged to the new
epoch and kept — and reports ``deltas_applied`` / ``edges_added`` /
``edges_removed`` / ``scoped_invalidations`` /
``warm_start_iterations_saved`` telemetry.
"""
from repro_torch.core.coo import EdgeMergeInfo, merge_edge_delta, quantize_values
from repro_torch.graph_updates.delta import EdgeDelta, localized_delta, random_delta
from repro_torch.graph_updates.warmstart import WarmStartStore

__all__ = [
    "EdgeDelta", "random_delta", "localized_delta", "WarmStartStore",
    "EdgeMergeInfo", "merge_edge_delta", "quantize_values",
]
