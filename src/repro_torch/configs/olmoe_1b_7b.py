"""OLMoE-1B-7B [arXiv:2409.02060; hf:allenai/OLMoE-1B-7B-0924].

16L d_model=2048 16H (kv=16, head_dim=128) vocab=50304,
MoE: 64 experts, top-8, expert d_ff=1024, QK-norm.
"""

from repro_torch.config.base import ModelConfig, register_arch


@register_arch("olmoe-1b-7b")
def config() -> ModelConfig:
    return ModelConfig(
        name="olmoe-1b-7b",
        family="moe",
        n_layers=16,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        head_dim=128,
        d_ff=1024,
        vocab_size=50_304,
        qk_norm=True,
        n_experts=64,
        top_k=8,
        moe_d_ff=1024,
        activation="silu",
        rope_theta=10_000.0,
    )
