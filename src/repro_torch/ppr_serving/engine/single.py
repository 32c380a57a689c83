"""Single-device engines: the paper's datapaths on one device's edge stream.

Counterpart of ``repro.ppr_serving.engine.single``.  ``FloatEngine`` is the
F32 reference architecture; ``FixedEngine`` is the reduced-precision datapath
(truncating Qm.f multiplies, raw-domain sums — bit-exact against the FPGA
model).  Both run plain PyTorch operations on the full-layout device arrays,
as the reference runs XLA operations there.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.core.fixed_point import QFormat
from repro_torch.core.ppr import (
    make_ppr_fixed_step,
    personalization_matrix,
    personalization_matrix_fixed,
    ppr_step_float,
)
from repro_torch.ppr_serving.engine.base import WaveEngine, WavePlan, register_engine

__all__ = ["FloatEngine", "FixedEngine"]


@register_engine
class FloatEngine(WaveEngine):
    """float32 eq. (1) iterations over the full-layout edge stream."""

    key = "float"
    family = "single"
    fixed = False

    def prepare(self, rg, fmt: Optional[QFormat] = None) -> None:
        rg.device_full()

    def plan(self, rg, fmt: Optional[QFormat] = None, *, alpha: float,
             iterations: int, convergence=None,
             topk_tile: Optional[int] = None, trace_hook=None) -> WavePlan:
        x, y, val = rg.device_full()
        dangling = rg.dangling
        num_vertices = rg.num_vertices

        def step(Vmat, P):
            return ppr_step_float(x, y, val, dangling, Vmat, P,
                                  num_vertices=num_vertices, alpha=alpha)

        return WavePlan(
            engine=self.key, fixed=False, scale=None,
            initial=lambda pers: personalization_matrix(num_vertices, pers),
            step=step,
            iterate=self._make_iterate(iterations, convergence, False, None,
                                        trace_hook=trace_hook),
            topk=self._make_topk(topk_tile))

    def on_delta(self, rg, info) -> None:
        rg.refresh_device_base()


@register_engine
class FixedEngine(WaveEngine):
    """Bit-exact reduced-precision iterations in one Q format's raw domain."""

    key = "fixed"
    family = "single"
    fixed = True

    def prepare(self, rg, fmt: Optional[QFormat] = None) -> None:
        if fmt is None:
            raise ValueError(f"{self.key!r} engine needs a concrete Q format")
        rg.quantized(fmt)

    def plan(self, rg, fmt: Optional[QFormat] = None, *, alpha: float,
             iterations: int, convergence=None,
             topk_tile: Optional[int] = None, trace_hook=None) -> WavePlan:
        if fmt is None:
            raise ValueError(f"{self.key!r} engine needs a concrete Q format")
        body = make_ppr_fixed_step(fmt, rg.num_vertices, alpha)
        x, y, _ = rg.device_full()
        val_raw = rg.quantized(fmt)
        dangling = rg.dangling
        num_vertices = rg.num_vertices

        def step(Vmat, P):
            return body(x, y, val_raw, dangling, Vmat, P)

        return WavePlan(
            engine=self.key, fixed=True, scale=fmt.scale,
            initial=lambda pers: personalization_matrix_fixed(
                num_vertices, pers, fmt),
            step=step,
            iterate=self._make_iterate(iterations, convergence, True, fmt.scale,
                                        trace_hook=trace_hook),
            topk=self._make_topk(topk_tile))

    def on_delta(self, rg, info) -> None:
        rg.refresh_device_base()
