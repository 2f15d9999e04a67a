"""deepseek-v2-236b [moe]: 60L d_model=5120 128H d_ff=1536 vocab=102400,
MLA kv_lora=512, MoE 2 shared + 160 routed top-6.  [arXiv:2405.04434]

MLA dims per the paper: qk_nope 128, decoupled-RoPE 64, v 128, q_lora 1536.
All layers are MoE (DeepSeek-V2 keeps layer 1 dense; a deviation the JAX
package makes, kept here so that both packages build the same model).
"""
from repro_torch.configs.base import AttnConfig, ModelConfig, MoEConfig
from repro_torch.configs.drafts import dense_draft

ARCH_ID = "deepseek-v2-236b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID, family="moe",
        n_layers=60, d_model=5120, d_ff=1536, vocab_size=102_400,
        attn=AttnConfig(kind="mla", n_heads=128, n_kv_heads=128, head_dim=128,
                        kv_lora_rank=512, q_lora_rank=1536,
                        rope_head_dim=64, v_head_dim=128, rope_theta=1e4),
        moe=MoEConfig(n_experts=160, top_k=6, d_ff_expert=1536,
                      n_shared=2, d_ff_shared=1536),
        source="arXiv:2405.04434",
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke", family="moe",
        n_layers=2, d_model=128, d_ff=96, vocab_size=512,
        attn=AttnConfig(kind="mla", n_heads=4, n_kv_heads=4, head_dim=32,
                        kv_lora_rank=32, q_lora_rank=48,
                        rope_head_dim=16, v_head_dim=32, rope_theta=1e4),
        moe=MoEConfig(n_experts=4, top_k=2, d_ff_expert=96,
                      n_shared=1, d_ff_shared=96, capacity_factor=2.0),
        source="reduced deepseek-v2 family variant for CPU smoke tests",
    )


def draft_config() -> ModelConfig:
    return dense_draft(config())
