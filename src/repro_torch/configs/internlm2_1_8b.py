"""internlm2-1.8b [dense]: 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92544, GQA.  [arXiv:2403.17297]  The training launcher's default:
at full width and depth its fp32 parameters, gradients and AdamW moments
(about 30 GB) fit one 80 GB card."""
from repro_torch.configs.base import AttnConfig, ModelConfig
from repro_torch.configs.drafts import dense_draft

ARCH_ID = "internlm2-1.8b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        n_layers=24, d_model=2048, d_ff=8192, vocab_size=92_544,
        attn=AttnConfig(n_heads=16, n_kv_heads=8, head_dim=128, rope_theta=1e6),
        source="arXiv:2403.17297",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="dense",
        n_layers=2, d_model=128, d_ff=256, vocab_size=512,
        attn=AttnConfig(n_heads=4, n_kv_heads=2, head_dim=32, rope_theta=1e6),
        source="reduced internlm2 family variant for CPU smoke tests",
    )


def draft_config() -> ModelConfig:
    return dense_draft(config())
