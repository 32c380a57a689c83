"""Blocked online-softmax attention — CUDA kernel and its plain version.

Replaces ``src/repro/kernels/flash_attention.py::flash_attention_pallas``
(body ``_fa_kernel``) and its GQA wrapper ``flash_attention_gqa``:
softmax(QKᵀ/√d + causal/window mask)·V with float32 statistics and
accumulator, output in q's dtype.  The kernels are in
``csrc/flash_attention.cu``; its header says how they map the TPU design.
Each input type has one kernel: bfloat16 runs on the tensor cores (wgmma on
operands that TMA brings into shared memory; P enters P·V as two bf16 terms,
since P rounded once to bf16 misses the bf16 tolerance), float32 on the CUDA
cores (the tensor cores would take float32 only as TF32, which misses the
float32 tolerance).

Fully masked rows output exactly 0, as the contract
(``kernels/ref.py::flash_attention_ref``) says.  The Pallas kernel's finite
``NEG_INF`` makes such rows output the mean of V instead; the port follows the
contract.

Bound on the H100: operations — 4·d FLOPs per unmasked (query, key) pair,
over 989 TFLOP/s in bf16 or 67 TFLOP/s in float32 — at the model's sequence
lengths; Q, K, V and O cross device memory once.

``flash_attention_gqa`` launches the kernel for CUDA tensors (reading kv
head ``h // (H/KV)`` in place) and raises on any operand it does not take;
for CPU tensors it runs ``flash_attention_gqa_plain``.
``flash_attention_gqa.launches`` counts the kernel launches;
``flash_attention`` ([BH, S, d] operands) goes through it.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import _build
from repro_torch.kernels._build import check_operand
from repro_torch.kernels.ref import flash_attention_ref

__all__ = ["flash_attention", "flash_attention_gqa", "flash_attention_gqa_plain"]


def _check_blocks(sq: int, skv: int, bq: int, bk: int) -> None:
    if sq % bq or skv % bk:
        raise ValueError(f"seq ({sq},{skv}) not divisible by blocks ({bq},{bk})")


def flash_attention_gqa_plain(q, k, v, *, causal: bool = True, window: int = 0):
    """The kernel's function in plain PyTorch (the oracle over repeated kv
    heads): q [B,Sq,H,hd], k/v [B,Skv,KV,hd] → [B,Sq,H,hd]."""
    b, sq, h, hd = q.shape
    g = h // k.shape[2]
    kb = k.repeat_interleave(g, dim=2)
    vb = v.repeat_interleave(g, dim=2)
    qf = q.transpose(1, 2).reshape(b * h, sq, hd)
    kf = kb.transpose(1, 2).reshape(b * h, k.shape[1], hd)
    vf = vb.transpose(1, 2).reshape(b * h, v.shape[1], hd)
    o = flash_attention_ref(qf, kf, vf, causal=causal, window=window)
    return o.reshape(b, h, sq, hd).transpose(1, 2)


def _declare(lib) -> None:
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_attention_launch.argtypes = ([vp] * 4 + [ctypes.POINTER(ctypes.c_int64)]
                                           + [i] * 8 + [ctypes.c_float, i, vp])
    lib.flash_attention_launch.restype = i
    lib.flash_attention_error_string.argtypes = [i]
    lib.flash_attention_error_string.restype = ctypes.c_char_p


def flash_attention_gqa(q, k, v, *, causal: bool = True, window: int = 0,
                        bq: int = 128, bk: int = 128) -> torch.Tensor:
    """GQA attention: q [B,Sq,H,hd], k/v [B,Skv,KV,hd] → [B,Sq,H,hd].

    ``bq``/``bk`` keep the reference's contract: sequence lengths they do not
    divide raise ``ValueError``.  They are not the CUDA tile."""
    b, sq, h, hd = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    _check_blocks(sq, skv, bq, bk)
    if h % kvh:
        raise ValueError(f"{h} query heads do not group over {kvh} kv heads")
    if q.device.type == "cpu":
        return flash_attention_gqa_plain(q, k, v, causal=causal, window=window)
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    for t, name in ((q, "q"), (k, "k"), (v, "v")):
        check_operand(t, name, q.dtype, dims=4, align=16)
    if tuple(k.shape) != tuple(v.shape) or k.shape[0] != b or k.shape[3] != hd:
        raise ValueError(f"k/v {tuple(k.shape)}/{tuple(v.shape)} do not match "
                         f"q {tuple(q.shape)}")
    if hd % 32 or hd > 256:
        raise ValueError(f"the kernel takes head_dim a multiple of 32 up to 256, got {hd}")
    if q.dtype == torch.bfloat16:
        for t, name in ((q, "q"), (k, "k")):
            if any(st * t.element_size() % 16 for st in t.stride()[:3]):
                raise ValueError(f"the bf16 kernel's TMA maps need {name}'s strides to "
                                 f"be multiples of 16 bytes, got {t.stride()}")
    out = torch.empty_like(q)
    if out.numel() == 0:
        return out
    if skv == 0:                    # no key at all: every row is fully masked
        return out.zero_()
    strides = (ctypes.c_int64 * 6)(q.stride(0), q.stride(1), q.stride(2),
                                   k.stride(0), k.stride(1), k.stride(2))
    lib = _build.load("flash_attention", _declare)
    with torch.cuda.device(q.device):
        status = lib.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), strides,
            b, h, kvh, sq, skv, hd, int(causal), int(window),
            1.0 / math.sqrt(hd), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream)
    if status:
        raise RuntimeError(f"flash_attention launch failed: "
                           f"{lib.flash_attention_error_string(status).decode()}")
    flash_attention_gqa.launches += 1
    return out


flash_attention_gqa.launches = 0


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0,
                    bq: int = 128, bk: int = 128) -> torch.Tensor:
    """q/k/v [BH, S, d] → [BH, Sq, d] (the reference's
    ``flash_attention_pallas`` signature, without ``interpret``)."""
    out = flash_attention_gqa(q[:, :, None], k[:, :, None], v[:, :, None],
                              causal=causal, window=window, bq=bq, bk=bk)
    return out[:, :, 0]
