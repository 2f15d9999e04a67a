"""qwen3-8b [dense]: 36L d_model=4096 32H (GQA kv=8) d_ff=12288 vocab=151936,
qk_norm, GQA.  [hf:Qwen/Qwen3-8B]"""
from repro_torch.configs.base import AttnConfig, ModelConfig
from repro_torch.configs.drafts import dense_draft

ARCH_ID = "qwen3-8b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        n_layers=36, d_model=4096, d_ff=12_288, vocab_size=151_936,
        attn=AttnConfig(n_heads=32, n_kv_heads=8, head_dim=128,
                        qk_norm=True, rope_theta=1e6),
        source="hf:Qwen/Qwen3-8B",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="dense",
        n_layers=2, d_model=128, d_ff=384, vocab_size=512,
        attn=AttnConfig(n_heads=4, n_kv_heads=2, head_dim=32,
                        qk_norm=True, rope_theta=1e6),
        source="reduced qwen3 family variant for CPU smoke tests",
    )


def draft_config() -> ModelConfig:
    return dense_draft(config())
