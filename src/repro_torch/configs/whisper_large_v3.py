"""Whisper large-v3 [arXiv:2212.04356; hf:openai/whisper-large-v3] (backbone).

Encoder-decoder, 32+32L, d_model=1280 20H (head_dim=64) d_ff=5120
vocab=51866, GELU, LayerNorm. The conv/mel frontend is a stub: the
encoder takes post-conv frame embeddings
(:func:`repro_torch.models.frontends.audio_frames_stub`).
"""

from repro_torch.config.base import ModelConfig, register_arch


@register_arch("whisper-large-v3")
def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-large-v3",
        family="encdec",
        n_layers=32,
        n_enc_layers=32,
        is_encdec=True,
        d_model=1280,
        n_heads=20,
        n_kv_heads=20,
        head_dim=64,
        d_ff=5120,
        vocab_size=51_866,
        activation="gelu",
        norm_kind="layernorm",
        tie_embeddings=True,
        frontend="audio",
        enc_ctx=1500,
        rope_theta=0.0,  # absolute positions, no RoPE
    )
