"""qwen3-moe-30b-a3b [moe]: 48L d_model=2048 32H (GQA kv=4) d_ff=768
vocab=151936, qk_norm, MoE 128 experts top-8.  [hf:Qwen/Qwen3-30B-A3B]"""
from repro_torch.configs.base import AttnConfig, ModelConfig, MoEConfig
from repro_torch.configs.drafts import dense_draft

ARCH_ID = "qwen3-moe-30b-a3b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="moe",
        n_layers=48, d_model=2048, d_ff=768, vocab_size=151_936,
        attn=AttnConfig(n_heads=32, n_kv_heads=4, head_dim=128,
                        qk_norm=True, rope_theta=1e6),
        moe=MoEConfig(n_experts=128, top_k=8, d_ff_expert=768),
        source="hf:Qwen/Qwen3-30B-A3B",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="moe",
        n_layers=2, d_model=128, d_ff=96, vocab_size=512,
        attn=AttnConfig(n_heads=4, n_kv_heads=2, head_dim=32,
                        qk_norm=True, rope_theta=1e6),
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=96, capacity_factor=2.0),
        source="reduced qwen3-moe family variant for CPU smoke tests",
    )


def draft_config() -> ModelConfig:
    return dense_draft(config())
