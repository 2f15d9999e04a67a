"""The paper's own evaluation pair (§5.1): OPT-6.7B target + OPT-125M draft,
realized in the llama-style substrate (SwiGLU + RoPE + RMSNorm) at OPT's
published widths, as ``repro.configs.opt_pair`` does.
"""
from repro_torch.configs.base import AttnConfig, ModelConfig

ARCH_ID = "opt-6.7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="dense",
        n_layers=32, d_model=4096, d_ff=16_384, vocab_size=50_272,
        attn=AttnConfig(n_heads=32, n_kv_heads=32, head_dim=128, rope_theta=1e4),
        source="arXiv:2205.01068 (paper §5.1 target LLM)",
    )


def draft_config() -> ModelConfig:
    return ModelConfig(
        name="opt-125m", family="dense",
        n_layers=12, d_model=768, d_ff=3072, vocab_size=50_272,
        attn=AttnConfig(n_heads=12, n_kv_heads=12, head_dim=64, rope_theta=1e4),
        source="arXiv:2205.01068 (paper §5.1 draft SSM)",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="dense",
        n_layers=2, d_model=128, d_ff=512, vocab_size=512,
        attn=AttnConfig(n_heads=4, n_kv_heads=4, head_dim=32, rope_theta=1e4),
        source="reduced OPT-pair variant for CPU smoke tests",
    )
