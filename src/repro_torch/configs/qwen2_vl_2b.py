"""Qwen2-VL-2B [arXiv:2409.12191; hf:Qwen/Qwen2-VL-2B-Instruct] (backbone).

28L d_model=1536 12H (GQA kv=2, head_dim=128) d_ff=8960 vocab=151936.
M-RoPE with (t,h,w) sections (16,24,24) over the 64 rotary half-dims;
QKV bias. The vision patch frontend is a stub
(:func:`repro_torch.models.frontends.vision_stream_stub`).
"""

from repro_torch.config.base import ModelConfig, register_arch


@register_arch("qwen2-vl-2b")
def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-2b",
        family="dense",
        n_layers=28,
        d_model=1536,
        n_heads=12,
        n_kv_heads=2,
        head_dim=128,
        d_ff=8960,
        vocab_size=151_936,
        qkv_bias=True,
        mrope_sections=(16, 24, 24),
        activation="silu",
        tie_embeddings=True,
        rope_theta=1_000_000.0,
        frontend="vision",
    )
