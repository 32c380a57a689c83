"""The 10 architectures of the reference, as data (copy of ``repro.configs.archs``).

``layer_pattern`` encodes per-layer structure: 0 = global attention, W>0 = local
attention with window W, -1 = mamba2 layer (see configs/base.py).
"""
from __future__ import annotations

from repro_torch.configs.base import FULL_ATTN, MAMBA, ModelConfig

# [arXiv:2408.00118] 46L, local(4096)/global alternating, GQA 32/16, softcaps.
GEMMA2_27B = ModelConfig(
    name="gemma2-27b", family="dense",
    num_layers=46, d_model=4608, num_heads=32, num_kv_heads=16, head_dim=128,
    d_ff=36864, vocab_size=256000,
    layer_pattern=(4096, FULL_ATTN) * 23,
    attn_softcap=50.0, logit_softcap=30.0, post_norms=True,
    act="gelu", embed_scale=True, tie_embeddings=True,
)

# [arXiv:2403.08295] 18L, MQA (kv=1), GeGLU, head_dim=256.
GEMMA_2B = ModelConfig(
    name="gemma-2b", family="dense",
    num_layers=18, d_model=2048, num_heads=8, num_kv_heads=1, head_dim=256,
    d_ff=16384, vocab_size=256000,
    layer_pattern=(FULL_ATTN,) * 18,
    act="gelu", embed_scale=True, tie_embeddings=True,
)

# [arXiv:2402.19173] 40L, GQA 48/4, RoPE theta=1e5, LayerNorm, plain-GELU MLP.
STARCODER2_15B = ModelConfig(
    name="starcoder2-15b", family="dense",
    num_layers=40, d_model=6144, num_heads=48, num_kv_heads=4, head_dim=128,
    d_ff=24576, vocab_size=49152,
    layer_pattern=(FULL_ATTN,) * 40,
    norm="layernorm", mlp="plain", act="gelu", rope_theta=1e5,
    tie_embeddings=False,
)

# [hf:google/gemma-3] 34L, 5:1 local(1024):global, GQA 8/4, qk-norm, 262k vocab.
GEMMA3_4B = ModelConfig(
    name="gemma3-4b", family="dense",
    num_layers=34, d_model=2560, num_heads=8, num_kv_heads=4, head_dim=256,
    d_ff=10240, vocab_size=262144,
    layer_pattern=((1024,) * 5 + (FULL_ATTN,)) * 5 + (1024,) * 4,
    use_qk_norm=True, post_norms=True, act="gelu", rope_theta=1e6,
    embed_scale=True, tie_embeddings=True,
)

# [hf:microsoft/Phi-3-vision] phi3-mini backbone (32L/3072/32H) + 576-patch stub.
PHI3_VISION_4B = ModelConfig(
    name="phi-3-vision-4.2b", family="vlm",
    num_layers=32, d_model=3072, num_heads=32, num_kv_heads=32, head_dim=96,
    d_ff=8192, vocab_size=32064,
    layer_pattern=(FULL_ATTN,) * 32,
    act="silu", tie_embeddings=False, num_patches=576,
)

# [arXiv:2212.04356] whisper-medium: 24 enc + 24 dec, d=1024, conv frontend stub.
WHISPER_MEDIUM = ModelConfig(
    name="whisper-medium", family="encdec",
    num_layers=24, d_model=1024, num_heads=16, num_kv_heads=16, head_dim=64,
    d_ff=4096, vocab_size=51865,
    layer_pattern=(FULL_ATTN,) * 24,
    norm="layernorm", mlp="plain", act="gelu", learned_pos=True,
    enc_layers=24, enc_len=1500, tie_embeddings=True,
)

# [arXiv:2401.04088] mixtral: 32L, 8 experts top-2, SWA 4096, GQA 32/8.
MIXTRAL_8X7B = ModelConfig(
    name="mixtral-8x7b", family="moe",
    num_layers=32, d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
    d_ff=14336, vocab_size=32000,
    layer_pattern=(4096,) * 32,
    num_experts=8, experts_per_token=2, rope_theta=1e6,
    tie_embeddings=False,
)

# [hf:moonshotai/Moonlight-16B-A3B] 48L, 64 experts top-6, expert d_ff=1408.
MOONSHOT_16B = ModelConfig(
    name="moonshot-v1-16b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=16, num_kv_heads=16, head_dim=128,
    d_ff=1408, vocab_size=163840,
    layer_pattern=(FULL_ATTN,) * 48,
    num_experts=64, experts_per_token=6,
    tie_embeddings=False,
)

# [arXiv:2405.21060] mamba2: 48 SSD layers, d=2048, state=128, attention-free.
MAMBA2_1_3B = ModelConfig(
    name="mamba2-1.3b", family="ssm",
    num_layers=48, d_model=2048, num_heads=1, num_kv_heads=1, head_dim=64,
    d_ff=0, vocab_size=50280,
    layer_pattern=(MAMBA,) * 48,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2,
    tie_embeddings=True,
)

# [arXiv:2411.15242] zamba2: 38 mamba2 layers + shared attention block every 6.
ZAMBA2_1_2B = ModelConfig(
    name="zamba2-1.2b", family="hybrid",
    num_layers=38, d_model=2048, num_heads=32, num_kv_heads=32, head_dim=64,
    d_ff=8192, vocab_size=32000,
    layer_pattern=(MAMBA,) * 38,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2,
    shared_attn_every=6, tie_embeddings=True,
)

ALL_ARCHS = {
    c.name: c
    for c in [
        GEMMA2_27B, GEMMA_2B, STARCODER2_15B, GEMMA3_4B, PHI3_VISION_4B,
        WHISPER_MEDIUM, MIXTRAL_8X7B, MOONSHOT_16B, MAMBA2_1_3B, ZAMBA2_1_2B,
    ]
}
