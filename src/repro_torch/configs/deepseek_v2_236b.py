"""DeepSeek-V2 236B [arXiv:2405.04434; hf:deepseek-ai/DeepSeek-V2].

60L d_model=5120 128H vocab=102400. MLA (kv_lora=512, q_lora=1536,
qk_nope=128, qk_rope=64, v_head=128). MoE: 160 routed experts top-6 +
2 shared, expert d_ff=1536; first layer dense with d_ff=12288.
"""

from repro_torch.config.base import ModelConfig, register_arch


@register_arch("deepseek-v2-236b")
def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v2-236b",
        family="moe",
        n_layers=60,
        d_model=5120,
        n_heads=128,
        n_kv_heads=128,
        head_dim=128,
        d_ff=1536,
        vocab_size=102_400,
        use_mla=True,
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
        n_experts=160,
        n_shared_experts=2,
        top_k=6,
        moe_d_ff=1536,
        first_dense_layers=1,
        dense_d_ff=12288,
        activation="silu",
        rope_theta=10_000.0,
    )
