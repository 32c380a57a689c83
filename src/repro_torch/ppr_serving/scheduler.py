"""κ-batch admission scheduler — the paper's batching as a serving policy.

Mirrors ``repro.serving.engine``'s slot batcher, specialized for PPR: one wave
amortizes a full edge-stream pass over up to κ personalization vertices, so
admission fills waves per (graph, precision, mesh, epoch) key — queries on
different graphs, Q formats, mesh layouts, or delta epochs cannot share a
stream and therefore never share a wave.

Flush policy (deadline-aware): a full wave of κ launches immediately; a
partially-full wave launches once *any* occupant has waited out its admission
budget — min(service ``max_wait``, the query's own ``deadline``) — so a
trickle of traffic still gets bounded latency at the cost of occupancy.
Time is injectable (``time_fn``) to keep the policy deterministic under test.
"""
from __future__ import annotations

import dataclasses
import heapq
import itertools
import time
from collections import OrderedDict
from typing import Any, Hashable, List, Optional, Tuple


@dataclasses.dataclass
class _Pending:
    item: Any
    enqueued_at: float
    deadline: Optional[float]      # max seconds this item may wait for batching

    def flush_at(self, max_wait: float) -> float:
        budget = max_wait if self.deadline is None else min(max_wait, self.deadline)
        return self.enqueued_at + budget


@dataclasses.dataclass
class Wave:
    """One κ-batched launch: all items share one (graph, precision, mesh,
    epoch) stream."""
    key: Hashable                  # (graph, precision, mesh_key, epoch) in the
    items: List[Any]               # PPR service (epoch = the graph's delta count)
    full: bool                     # False ⇒ deadline-flushed partial wave
    # per-item submit times (parallel to ``items``): launch time minus these
    # is each occupant's admission wait — the queue-time half of its latency,
    # which the launch path would otherwise lose the moment the wave forms
    enqueued_at: List[float] = dataclasses.field(default_factory=list)

    def __len__(self) -> int:
        return len(self.items)


class WaveScheduler:
    def __init__(self, kappa: int, max_wait: float = 0.0, time_fn=time.monotonic):
        if kappa < 1:
            raise ValueError(f"kappa must be >= 1, got {kappa}")
        self.kappa = kappa
        self.max_wait = max_wait
        self.time_fn = time_fn
        self._queues: "OrderedDict[Hashable, List[_Pending]]" = OrderedDict()
        self._depth = 0                # maintained by every mutation below
        # lazy min-heap of (head enqueue stamp, seq, key): each queue is FIFO
        # in enqueue time, so the globally oldest pending item is some queue's
        # head.  Mutations push a fresh entry whenever a queue's head changes;
        # reads pop entries that no longer describe a live head.  seq breaks
        # stamp ties without ever comparing (possibly heterogeneous) keys.
        self._heads: List[Tuple[float, int, Hashable]] = []
        self._head_seq = itertools.count()

    def _note_head(self, key: Hashable) -> None:
        """Record ``key``'s current queue head in the lazy heap (no-op for an
        empty/absent queue — reads skip stale entries)."""
        q = self._queues.get(key)
        if q:
            heapq.heappush(self._heads,
                           (q[0].enqueued_at, next(self._head_seq), key))

    # ------------------------------------------------------------------
    def submit(self, key: Hashable, item: Any,
               deadline: Optional[float] = None,
               now: Optional[float] = None) -> None:
        now = self.time_fn() if now is None else now
        q = self._queues.setdefault(key, [])
        q.append(_Pending(item, now, deadline))
        self._depth += 1
        if len(q) == 1:                # new head ⇒ new heap entry
            self._note_head(key)

    def pending(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def queue_depth(self) -> int:
        """Total pending queries across every wave key — O(1).

        The admission controller reads this on *every* arrival (shed/admit is
        a per-request decision), so it must not walk the pending dicts the way
        ``pending()`` does."""
        return self._depth

    def oldest_wait_s(self, now: Optional[float] = None) -> float:
        """Seconds the longest-waiting pending query has been queued (0.0
        when nothing is pending).

        Amortized O(1): the lazy head heap already orders the per-key queue
        heads by enqueue stamp, so a read peeks the top and only pops entries
        invalidated since they were pushed (each mutation creates at most one
        such entry, and each is discarded exactly once).  The pump reads this
        on every control tick and ``submit`` records it on every arrival —
        the previous every-key scan was per-arrival work proportional to the
        number of live (graph, precision, mesh, epoch) streams."""
        if not self._queues:
            return 0.0
        now = self.time_fn() if now is None else now
        while self._heads:
            stamp, _, key = self._heads[0]
            q = self._queues.get(key)
            if q is not None and q and q[0].enqueued_at == stamp:
                return max(0.0, now - stamp)
            heapq.heappop(self._heads)     # stale: head moved or queue died
        return 0.0

    def purge(self, key_predicate, item_predicate=None) -> int:
        """Drop pending queries whose wave key satisfies ``key_predicate``;
        returns the number dropped.  Used when a graph is re-registered: its
        queued queries were validated against the old topology (their vertices
        may not even exist in the new one) and must not launch.

        With ``item_predicate``, only matching items inside matching keys are
        dropped (delta ingestion's scoped purge: pending queries whose vertex
        falls in the affected frontier go, co-queued queries stay)."""
        dropped = 0
        for key in [k for k in self._queues if key_predicate(k)]:
            if item_predicate is None:
                dropped += len(self._queues.pop(key))
                continue
            q = self._queues[key]
            kept = [p for p in q if not item_predicate(p.item)]
            dropped += len(q) - len(kept)
            if kept:
                head_moved = kept[0] is not q[0]
                self._queues[key] = kept
                if head_moved:
                    self._note_head(key)
            else:
                del self._queues[key]
        self._depth -= dropped
        return dropped

    def extract(self, key_predicate) -> List[tuple]:
        """Pop every pending entry under matching keys, returning
        ``(key, item, enqueued_at, deadline)`` tuples in queue order.

        Delta ingestion uses this to move a graph's surviving pending queries
        onto new epoch-tagged wave keys: re-``submit`` with ``now=enqueued_at``
        preserves each query's admission budget across the move."""
        out: List[tuple] = []
        for key in [k for k in self._queues if key_predicate(k)]:
            for p in self._queues.pop(key):
                out.append((key, p.item, p.enqueued_at, p.deadline))
        self._depth -= len(out)
        return out

    def flush_keys(self, keys) -> List[Wave]:
        """Pop the named keys' queues as waves regardless of occupancy or
        deadline (κ-chunked like ``drain``).  The prefetcher uses this to
        launch its synthetic queries immediately during an idle pump instead
        of leaving them to age in the admission queue."""
        waves: List[Wave] = []
        for key in [k for k in self._queues if k in keys]:
            q = self._queues.pop(key)
            self._depth -= len(q)
            for i in range(0, len(q), self.kappa):
                chunk = q[i: i + self.kappa]
                waves.append(Wave(key, [p.item for p in chunk],
                                  full=len(chunk) == self.kappa,
                                  enqueued_at=[p.enqueued_at for p in chunk]))
        return waves

    # ------------------------------------------------------------------
    def ready_waves(self, now: Optional[float] = None) -> List[Wave]:
        """Pop every launchable wave: all full waves, plus partial waves in
        which *any* occupant's admission budget has expired (a late query with
        a tight deadline must not wait on the oldest occupant's looser one;
        the whole partial queue rides the flushed wave — that is the point of
        batching)."""
        now = self.time_fn() if now is None else now
        waves: List[Wave] = []
        for key in list(self._queues):
            q = self._queues[key]
            popped_full = False
            while len(q) >= self.kappa:
                waves.append(Wave(key, [p.item for p in q[: self.kappa]],
                                  full=True,
                                  enqueued_at=[p.enqueued_at
                                               for p in q[: self.kappa]]))
                del q[: self.kappa]
                self._depth -= self.kappa
                popped_full = True
            if q and now >= min(p.flush_at(self.max_wait) for p in q):
                waves.append(Wave(key, [p.item for p in q], full=False,
                                  enqueued_at=[p.enqueued_at for p in q]))
                self._depth -= len(q)
                q.clear()
            if not q:
                del self._queues[key]
            elif popped_full:          # survivors promoted: new queue head
                self._note_head(key)
        return waves

    def drain(self) -> List[Wave]:
        """Flush everything unconditionally (end-of-batch / shutdown path)."""
        return self.flush_keys(set(self._queues))
