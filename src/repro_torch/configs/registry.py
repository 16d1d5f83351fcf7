"""Registry of the 10 assigned architectures. ``get(name)``/``--arch <id>``."""
from __future__ import annotations

from .base import ArchConfig, MoECfg, MambaCfg

# --------------------------------------------------------------------------
# LM-family transformers (exact configs from the assignment / public lit)
# --------------------------------------------------------------------------
PHI3_MEDIUM_14B = ArchConfig(
    name="phi3-medium-14b", family="dense",
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=10, head_dim=128,
    d_ff=17920, vocab=100352, act="swiglu", rope_type="std",
)  # [arXiv:2404.14219] RoPE SwiGLU GQA

INTERNLM2_20B = ArchConfig(
    name="internlm2-20b", family="dense",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=16384, vocab=92544, act="swiglu", rope_type="std",
)  # [arXiv:2403.17297]

GEMMA_7B = ArchConfig(
    name="gemma-7b", family="dense",
    n_layers=28, d_model=3072, n_heads=16, n_kv_heads=16, head_dim=256,
    d_ff=24576, vocab=256000, act="geglu", rope_type="std",
    tie_embeddings=True,
)  # [arXiv:2403.08295] GeGLU, head_dim=256

COMMAND_R_PLUS_104B = ArchConfig(
    name="command-r-plus-104b", family="dense",
    n_layers=64, d_model=12288, n_heads=96, n_kv_heads=8, head_dim=128,
    d_ff=33792, vocab=256000, act="swiglu", rope_type="std",
    fsdp=True,
)  # [hf:CohereForAI] GQA, no-bias

GROK_1_314B = ArchConfig(
    name="grok-1-314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=0, vocab=131072, act="geglu", rope_type="std",
    moe=MoECfg(n_experts=8, top_k=2, d_ff_expert=32768, every=1,
               shard="ffn"),   # 8 experts < 16-way model axis → shard d_ff
    fsdp=True,
)  # [hf:xai-org/grok-1] 8e top-2

QWEN3_MOE_30B_A3B = ArchConfig(
    name="qwen3-moe-30b-a3b", family="moe",
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=4, head_dim=128,
    d_ff=0, vocab=151936, act="swiglu", rope_type="std",
    moe=MoECfg(n_experts=128, top_k=8, d_ff_expert=768, every=1,
               shard="expert"),
)  # [hf:Qwen/Qwen3-30B-A3B] 128e top-8

JAMBA_1_5_LARGE_398B = ArchConfig(
    name="jamba-1.5-large-398b", family="hybrid",
    n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=24576, vocab=65536, act="swiglu", rope_type=None,  # Jamba: no RoPE
    attn_every=8, mamba=MambaCfg(d_state=16, d_conv=4, expand=2),
    moe=MoECfg(n_experts=16, top_k=2, d_ff_expert=24576, every=2,
               shard="expert"),
    sub_quadratic=True, fsdp=True,
)  # [arXiv:2403.19887] Mamba+attn 1:7, MoE every 2

MUSICGEN_MEDIUM = ArchConfig(
    name="musicgen-medium", family="audio",
    n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24, head_dim=64,
    d_ff=6144, vocab=2048, act="gelu", rope_type=None,
    embeddings_input=True,   # EnCodec frame embeddings (frontend stub)
)  # [arXiv:2306.05284] decoder-only over EnCodec tokens

RWKV6_1_6B = ArchConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=0, n_kv_heads=0,
    d_ff=7168, vocab=65536, act="rwkv", rope_type=None,
    rwkv6=True, rwkv_head_size=64, sub_quadratic=True,
)  # [arXiv:2404.05892] Finch, data-dependent decay

QWEN2_VL_7B = ArchConfig(
    name="qwen2-vl-7b", family="vlm",
    n_layers=28, d_model=3584, n_heads=28, n_kv_heads=4, head_dim=128,
    d_ff=18944, vocab=152064, act="swiglu", rope_type="mrope",
    mrope_sections=(16, 24, 24), qkv_bias=True,
    embeddings_input=True,   # vision patch embeddings (frontend stub)
)  # [arXiv:2409.12191] M-RoPE, dynamic resolution


ARCHS = {c.name: c for c in [
    PHI3_MEDIUM_14B, INTERNLM2_20B, GEMMA_7B, COMMAND_R_PLUS_104B,
    GROK_1_314B, QWEN3_MOE_30B_A3B, JAMBA_1_5_LARGE_398B, MUSICGEN_MEDIUM,
    RWKV6_1_6B, QWEN2_VL_7B,
]}


def get(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]
