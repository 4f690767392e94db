"""Qwen1.5-0.5B [hf:Qwen/Qwen1.5-0.5B].

24L d_model=1024 16H (MHA, kv=16, head_dim=64) d_ff=2816 vocab=151936.
QKV bias, SwiGLU, tied embeddings, rope_theta=1e6.
"""

from repro_torch.config.base import ModelConfig, register_arch


@register_arch("qwen1.5-0.5b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen1.5-0.5b",
        family="dense",
        n_layers=24,
        d_model=1024,
        n_heads=16,
        n_kv_heads=16,
        head_dim=64,
        d_ff=2816,
        vocab_size=151_936,
        qkv_bias=True,
        activation="silu",
        tie_embeddings=True,
        rope_theta=1_000_000.0,
    )
