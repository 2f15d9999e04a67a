"""mamba2-1.3b [ssm]: 48L d_model=2048 (attention-free) vocab=50280,
ssm_state=128, SSD (state-space duality).  [arXiv:2405.21060]  Its draft
is the dense 4-layer d=512 decoder of ``dense_draft`` with a 4096 window."""
from repro_torch.configs.base import ModelConfig, SSMConfig
from repro_torch.configs.drafts import dense_draft

ARCH_ID = "mamba2-1.3b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="ssm",
        n_layers=48, d_model=2048, d_ff=0, vocab_size=50_280,
        ssm=SSMConfig(d_state=128, head_dim=64, expand=2, chunk=256, d_conv=4, n_groups=1),
        source="arXiv:2405.21060",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="ssm",
        n_layers=2, d_model=128, d_ff=0, vocab_size=512,
        ssm=SSMConfig(d_state=16, head_dim=32, expand=2, chunk=8, d_conv=4, n_groups=1),
        source="reduced mamba2 family variant for CPU smoke tests",
    )


def draft_config() -> ModelConfig:
    return dense_draft(config())
