"""Reduced-precision unsigned fixed-point (Qm.f) arithmetic — the paper's §4.1 datapath.

Counterpart of ``repro.core.fixed_point``.  The paper stores PPR values as
unsigned Q1.25 / Q1.23 / Q1.21 / Q1.19 and *truncates* towards zero.

Representation (one rule for the whole port): a raw Qm.f value lives in a
``torch.int32`` tensor that holds the reference's uint32 bits.  ``torch.uint32``
is storage-only on the CPU, so the arithmetic here widens to int64
(``widen_u32``), computes exactly, and wraps back to 32 bits (``wrap_u32``).
The CUDA kernels reinterpret the same tensors as ``uint32_t``.

``mul`` is the low 32 bits of ``(a*b) >> f`` for any uint32 operands — what the
reference's 16-bit-limb multiply returns.  The int64 product ``a*b`` overflows
for 32-bit operands, so the product is split into two partial products of at
most 48 bits each.
"""
from __future__ import annotations

import dataclasses
import operator
from typing import Union

import torch

_MASK32 = 0xFFFFFFFF
_MASK16 = 0xFFFF

Raw = Union[torch.Tensor, int]


def wrap_u32(x: torch.Tensor) -> torch.Tensor:
    """int64 → int32 holding the low 32 bits (value mod 2^32 as uint32 bits)."""
    x = x.to(torch.int64) & _MASK32
    # repro: allow[FXP002] 1 << 32 is a Python int in int64 arithmetic on x; no uint32 lane is involved
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(torch.int32)


def widen_u32(raw: Raw, device=None) -> torch.Tensor:
    """int32 uint32-bits (or a Python int) → int64 in [0, 2^32)."""
    if not isinstance(raw, torch.Tensor):
        return torch.as_tensor(int(raw) & _MASK32, dtype=torch.int64, device=device)
    return raw.to(torch.int64) & _MASK32


def _device_of(*xs):
    for x in xs:
        if isinstance(x, torch.Tensor):
            return x.device
    return None


def mul_raw(a: Raw, b: Raw, frac_bits: int) -> torch.Tensor:
    """Low 32 bits of ``(a*b) >> frac_bits`` for uint32 operands.

    a = a1·2^16 + a0, so a·b = (a1·b)·2^16 + a0·b with both partial products
    below 2^48 — exact in int64.
    """
    dev = _device_of(a, b)
    a, b = widen_u32(a, dev), widen_u32(b, dev)
    f = frac_bits
    hi = (a >> 16) * b
    lo = (a & _MASK16) * b
    if f >= 16:
        out = (hi + (lo >> 16)) >> (f - 16)
    else:
        # (hi·2^16 + lo) >> f = hi·2^(16-f) + (lo >> f) exactly; keep only
        # what survives mod 2^32
        out = ((hi & _MASK32) << (16 - f)) + (lo >> f)
    return wrap_u32(out)


@dataclasses.dataclass(frozen=True)
class QFormat:
    """Unsigned Qm.f fixed point: ``int_bits`` integer bits, ``frac_bits`` fractional."""

    int_bits: int
    frac_bits: int

    def __post_init__(self):
        if self.int_bits < 1 or self.frac_bits < 0:
            raise ValueError(f"bad QFormat({self.int_bits},{self.frac_bits})")
        if self.total_bits > 32:
            raise ValueError("QFormat wider than 32 bits is not supported")

    @property
    def total_bits(self) -> int:
        return self.int_bits + self.frac_bits

    @property
    def scale(self) -> int:
        return 1 << self.frac_bits

    @property
    def max_raw(self) -> int:
        return (1 << self.total_bits) - 1

    @property
    def resolution(self) -> float:
        return 1.0 / self.scale

    @property
    def name(self) -> str:
        return f"Q{self.int_bits}.{self.frac_bits}"

    # ---- conversions -------------------------------------------------------
    def from_float(self, x) -> torch.Tensor:
        """Encode float → raw (int32 bits), truncating towards zero, in float32
        like the reference (which runs with 64-bit mode off)."""
        x = torch.as_tensor(x, dtype=torch.float32)
        raw = torch.floor(torch.clamp(x, min=0.0) * float(self.scale))
        raw = torch.clamp(raw, max=float(self.max_raw))
        return wrap_u32(raw.to(torch.int64))

    def to_float(self, raw: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
        return widen_u32(raw).to(dtype) / torch.as_tensor(self.scale, dtype=dtype)

    # ---- arithmetic on raw values -------------------------------------------
    def mul(self, a: Raw, b: Raw) -> torch.Tensor:
        """Low 32 bits of ``(a*b) >> f`` (the reference's limb multiply)."""
        return mul_raw(a, b, self.frac_bits)

    def add(self, a: Raw, b: Raw) -> torch.Tensor:
        """Saturating add on raw values: wrap or ``> max_raw`` → ``max_raw``."""
        dev = _device_of(a, b)
        s = widen_u32(a, dev) + widen_u32(b, dev)     # < 2^33, never wraps here
        return wrap_u32(torch.clamp(s, max=self.max_raw))

    def quantize_raw(self, raw_wide_float: torch.Tensor) -> torch.Tensor:
        """Clamp a float 'raw-units' value into the format (truncate)."""
        r = torch.floor(torch.clamp(raw_wide_float, 0.0, float(self.max_raw)))
        return wrap_u32(r.to(torch.int64))

    # ---- float-grid fast path ------------------------------------------------
    def quantize_f32(self, x: torch.Tensor) -> torch.Tensor:
        """Truncate a float value to the Qm.f grid: floor(x·2^f)/2^f, clipped."""
        scale = torch.as_tensor(self.scale, dtype=x.dtype)
        q = torch.floor(torch.clamp(x, min=0.0) * scale)
        q = torch.minimum(q, torch.as_tensor(float(self.max_raw), dtype=x.dtype))
        return q / scale


# The paper's four evaluated formats plus the f32 reference label.
Q1_25 = QFormat(1, 25)
Q1_23 = QFormat(1, 23)
Q1_21 = QFormat(1, 21)
Q1_19 = QFormat(1, 19)

PAPER_FORMATS = {
    "Q1.25": Q1_25,  # "26 bits"
    "Q1.23": Q1_23,  # "24 bits"
    "Q1.21": Q1_21,  # "22 bits"
    "Q1.19": Q1_19,  # "20 bits"
}

BITWIDTH_TO_FORMAT = {26: Q1_25, 24: Q1_23, 22: Q1_21, 20: Q1_19}


def format_for_bits(bits: int) -> QFormat:
    """Paper convention: 'b bits' = Q1.(b-1) unsigned (b ≥ 2)."""
    if isinstance(bits, bool):
        raise ValueError(f"bit-width must be an int, got {bits!r}")
    try:
        bits = int(operator.index(bits))   # accept numpy ints, reject floats
    except TypeError:
        raise ValueError(f"bit-width must be an int, got {bits!r}") from None
    if bits < 2:
        raise ValueError(
            f"bit-width must be >= 2 (1 integer + >=1 fractional bit), got {bits}")
    return BITWIDTH_TO_FORMAT.get(bits, QFormat(1, bits - 1))

