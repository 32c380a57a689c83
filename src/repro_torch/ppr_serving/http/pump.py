"""The event-loop pump — what actually drives the futures API on deadline.

Counterpart of ``repro.ppr_serving.http.pump``, copied (stdlib asyncio).

`PPRFuture` + ``poll()``/``flush()`` were designed to be driven by an event
loop; this is that loop's heartbeat.  A single asyncio task alternates

    admission.tick()  →  service.poll()  →  sleep(interval)

so deadline-expired partial waves launch within one interval of their
admission budget, full waves launch on the next cycle, and the admission
controller's shed/degrade/deepen state tracks the queue even when no
requests are arriving (recovery transitions happen *here*, as the queue
drains, not on the next arrival).  The heartbeat also carries the
observability duties that need a clock: SLO burn-rate evaluation (through
``admission.tick`` when a controller is attached, directly otherwise) and
OTLP export cycles (span-batch drains + periodic delta metric pushes, run
off the loop thread like wave compute; the stop path flushes the exporter
so shutdown loses no queued telemetry).

Wave compute is synchronous host code that enqueues device work; by default
it is offloaded to a dedicated single worker thread (``offload=True``), so
the event loop keeps admitting, shedding, and answering health checks
*during* a wave.  One worker means at most one wave pipeline runs at a time
(kernel launches stay serialized on that thread's current CUDA stream);
``PPRService`` guards its scheduler/cache/controller mutations with an
internal lock so loop-thread ``submit()`` can interleave with worker-thread
``poll()``.  ``offload=False`` restores the old in-loop behavior for
single-threaded debugging.
"""
from __future__ import annotations

import asyncio
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

__all__ = ["WavePump"]


class WavePump:
    """Owns the poll/tick task; start() is idempotent, stop() flushes."""

    def __init__(self, service, admission=None, interval_s: float = 0.005,
                 offload: bool = True):
        if interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {interval_s}")
        self.service = service
        self.admission = admission
        self.interval_s = interval_s
        self.offload = offload
        self.cycles = 0
        self.waves_launched = 0
        self._task: Optional[asyncio.Task] = None
        self._executor: Optional[ThreadPoolExecutor] = None
        # mirror the loop counters into the service's metrics registry so
        # /v1/metrics can answer "is the heartbeat alive" without /v1/stats
        registry = getattr(getattr(service, "telemetry", None),
                           "registry", None)
        if registry is not None:
            self._cycles_metric = registry.counter(
                "ppr_pump_cycles_total", "Pump heartbeat cycles run.")
            self._waves_metric = registry.counter(
                "ppr_pump_waves_launched_total",
                "Waves launched from pump cycles (incl. the stop flush).")
        else:
            self._cycles_metric = self._waves_metric = None

    # ------------------------------------------------------------------
    def start(self) -> None:
        if self._task is not None and not self._task.done():
            return
        if self.offload and self._executor is None:
            # one worker: waves stay serialized, the stop() flush queues
            # behind any in-flight poll on the same thread
            self._executor = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="ppr-wave")
        self._task = asyncio.get_running_loop().create_task(
            self._run(), name="ppr-wave-pump")

    async def _drive(self, fn) -> int:
        """Run one service-driving call (poll/flush) off the loop thread."""
        if self._executor is None:
            # repro: allow[ASY303] offload=False is the explicit single-threaded debug mode; blocking is opted into
            return fn()
        return await asyncio.get_running_loop().run_in_executor(
            self._executor, fn)

    async def stop(self) -> None:
        """Cancel the heartbeat, then flush: every admitted future resolves
        (shutdown must not leak pending futures — in-flight HTTP handlers
        are awaiting them)."""
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None
        flushed = await self._drive(self.service.flush)
        self.waves_launched += flushed
        if self._waves_metric is not None and flushed:
            self._waves_metric.get().inc(flushed)
        if self.admission is not None:
            self.admission.tick()      # record the drained queue / recovery
        elif getattr(self.service, "slo", None) is not None:
            self.service.slo.tick()
        if getattr(self.service, "otlp", None) is not None:
            # final export: queued spans and the closing delta window must
            # not die with the process
            await self._drive(lambda: self.service.otlp.flush(
                self.service.telemetry.registry))
        if self._executor is not None:
            self._executor.shutdown(wait=True)
            self._executor = None

    async def _run(self) -> None:
        while True:
            self.cycles += 1
            if self._cycles_metric is not None:
                self._cycles_metric.get().inc()
            if self.admission is not None:
                self.admission.tick()
            elif getattr(self.service, "slo", None) is not None:
                # no admission controller to carry the monitor: evaluate the
                # SLOs on the heartbeat anyway (alerting without the ladder)
                self.service.slo.tick()
            launched = await self._drive(self.service.poll)
            self.waves_launched += launched
            if self._waves_metric is not None and launched:
                self._waves_metric.get().inc(launched)
            otlp = getattr(self.service, "otlp", None)
            if otlp is not None and otlp.due():
                # exporter I/O (HTTP POSTs) stays off the event loop, like
                # wave compute; an idle cycle pays only the due() check
                await self._drive(self.service.export_telemetry)
            # a launch may have unblocked more ready waves (κ changed, or a
            # deadline expired mid-wave) — loop immediately while productive,
            # yielding to the loop so handlers can run between waves
            if launched:
                await asyncio.sleep(0)
            else:
                await asyncio.sleep(self.interval_s)
