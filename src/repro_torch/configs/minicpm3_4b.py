"""MiniCPM3-4B [hf:openbmb/MiniCPM3-4B].

62L d_model=2560 40H d_ff=6400 vocab=73448, MLA attention
(q_lora=768, kv_lora=256, qk_nope=64, qk_rope=32, v_head=64).
"""

from repro_torch.config.base import ModelConfig, register_arch


@register_arch("minicpm3-4b")
def config() -> ModelConfig:
    return ModelConfig(
        name="minicpm3-4b",
        family="dense",
        n_layers=62,
        d_model=2560,
        n_heads=40,
        n_kv_heads=40,
        head_dim=64,
        d_ff=6400,
        vocab_size=73_448,
        use_mla=True,
        q_lora_rank=768,
        kv_lora_rank=256,
        qk_nope_head_dim=64,
        qk_rope_head_dim=32,
        v_head_dim=64,
        activation="silu",
        tie_embeddings=True,
        emb_scale="const12",
        rope_theta=10_000.0,
    )
