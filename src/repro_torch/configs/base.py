"""Model/shape configuration (copy of ``repro.configs.base``).

One ``ModelConfig`` covers every architecture family of the reference (dense /
moe / ssm / hybrid / encdec / vlm); per-layer structure (local vs global
attention, mamba vs attention) is encoded in ``layer_pattern``.  The only
difference from the reference: ``act_dtype`` is a ``torch.dtype``.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

# layer_pattern entries
FULL_ATTN = 0          # global attention layer (window = whole sequence)
# any positive integer  = local attention with that window
MAMBA = -1             # mamba2 (SSD) layer


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                      # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    layer_pattern: Tuple[int, ...]   # len == num_layers (decoder side)

    # attention details
    rope_theta: float = 10_000.0
    attn_softcap: float = 0.0        # gemma2: 50.0
    logit_softcap: float = 0.0       # gemma2: 30.0
    use_qk_norm: bool = False        # gemma3
    norm: str = "rmsnorm"            # rmsnorm | layernorm
    mlp: str = "glu"                 # glu (gate+up+down) | plain (fc+proj)
    act: str = "silu"                # silu | gelu
    post_norms: bool = False         # gemma2/3 post-attn/post-mlp norms
    tie_embeddings: bool = True
    embed_scale: bool = False        # gemma: x *= sqrt(d)
    learned_pos: bool = False        # whisper decoder
    # MoE
    num_experts: int = 0
    experts_per_token: int = 0
    moe_capacity_factor: float = 1.25
    # SSM (mamba2)
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    # hybrid (zamba2): shared attention block applied every N layers
    shared_attn_every: int = 0
    # encoder-decoder (whisper)
    enc_layers: int = 0
    enc_len: int = 0                 # precomputed frame embeddings (stub frontend)
    # vlm (phi-3-vision)
    num_patches: int = 0             # precomputed patch embeddings (stub frontend)
    compute_dtype: str = "bfloat16"  # activations dtype (params stay f32)

    # ------------------------------------------------------------------
    @property
    def act_dtype(self) -> torch.dtype:
        return {"bfloat16": torch.bfloat16, "float32": torch.float32}[self.compute_dtype]

    @property
    def padded_vocab(self) -> int:
        """Vocab padded to a multiple of 256 so it shards over any mesh axis."""
        return (self.vocab_size + 255) // 256 * 256

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.ssm_d_inner // self.ssm_head_dim

    def param_count(self) -> int:
        """Analytic parameter count (embedding + layers), for 6·N·D roofline."""
        d, f, hd = self.d_model, self.d_ff, self.head_dim
        attn = d * (self.num_heads * hd) * 2 + d * (self.num_kv_heads * hd) * 2
        if self.mlp == "glu":
            dense_mlp = 3 * d * f
        else:
            dense_mlp = 2 * d * f
        if self.num_experts:
            moe_mlp = self.num_experts * 3 * d * f + d * self.num_experts
        else:
            moe_mlp = 0
        mamba = 0
        if self.ssm_state:
            di, st, nh = self.ssm_d_inner, self.ssm_state, self.ssm_heads
            # in_proj (z,x,B,C,dt) + conv + out_proj + A,D
            mamba = d * (2 * di + 2 * st + nh) + di * self.ssm_conv + di * d + 2 * nh
        total = 0
        for w in self.layer_pattern:
            if w == MAMBA:
                total += mamba
            else:
                total += attn + (moe_mlp if self.num_experts else dense_mlp)
            total += 4 * d  # norms
        if self.shared_attn_every:
            total += attn + dense_mlp  # one shared block
        if self.enc_layers:
            total += self.enc_layers * (attn + dense_mlp + 4 * d)
            total += self.num_layers * (attn + 2 * d)  # cross attention
        total += self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: only routed experts) for 6·N_active·D."""
        if not self.num_experts:
            return self.param_count()
        d, f = self.d_model, self.d_ff
        full_moe = self.num_experts * 3 * d * f
        active_moe = self.experts_per_token * 3 * d * f
        n_moe_layers = sum(1 for w in self.layer_pattern if w != MAMBA)
        return self.param_count() - n_moe_layers * (full_moe - active_moe)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One assigned input-shape cell."""

    name: str              # train_4k | prefill_32k | decode_32k | long_500k
    kind: str              # train | prefill | decode
    seq_len: int
    global_batch: int
    microbatches: int = 1  # gradient accumulation (train only)


SHAPES = {
    "train_4k": ShapeConfig("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524288, 1),
}


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests: few layers, small width,
    few experts, tiny vocab — preserves every structural feature."""
    n_layers = min(4, cfg.num_layers)
    pattern = cfg.layer_pattern[:n_layers]
    # keep at least one of each layer kind present in the original
    kinds = {w for w in cfg.layer_pattern}
    if MAMBA in kinds and MAMBA not in pattern:
        pattern = pattern[:-1] + (MAMBA,)
    if any(w > 0 for w in kinds) and not any(w > 0 for w in pattern):
        pattern = (8,) + pattern[1:]
    heads = min(4, cfg.num_heads)
    kv = max(1, min(cfg.num_kv_heads, heads))
    return dataclasses.replace(
        cfg,
        num_layers=n_layers,
        layer_pattern=tuple(min(w, 8) if w > 0 else w for w in pattern),
        d_model=128,
        num_heads=heads,
        num_kv_heads=kv,
        head_dim=32,
        d_ff=256,
        vocab_size=512,
        num_experts=min(cfg.num_experts, 4),
        experts_per_token=min(cfg.experts_per_token, 2),
        moe_capacity_factor=float(max(4, cfg.num_experts or 4)),  # dropless in smoke
        ssm_state=min(cfg.ssm_state, 16),
        ssm_head_dim=32 if cfg.ssm_state else cfg.ssm_head_dim,
        shared_attn_every=2 if cfg.shared_attn_every else 0,
        enc_layers=min(cfg.enc_layers, 2),
        enc_len=min(cfg.enc_len, 16) if cfg.enc_len else 0,
        num_patches=min(cfg.num_patches, 8) if cfg.num_patches else 0,
    )
