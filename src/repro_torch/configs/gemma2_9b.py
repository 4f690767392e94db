"""Gemma-2 9B [arXiv:2408.00118; hf:google/gemma-2-9b].

42L d_model=3584 16H (GQA kv=8, head_dim=256) d_ff=14336 vocab=256000.
Alternating local(4096-window)/global attention, attn logit softcap 50,
final logit softcap 30, GeGLU, sandwich (pre+post) RMSNorms, tied embeddings.
"""

from repro_torch.config.base import ModelConfig, register_arch


@register_arch("gemma2-9b")
def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-9b",
        family="dense",
        n_layers=42,
        d_model=3584,
        n_heads=16,
        n_kv_heads=8,
        head_dim=256,
        d_ff=14336,
        vocab_size=256_000,
        layer_pattern=("local", "global"),
        window=4096,
        attn_logit_softcap=50.0,
        final_logit_softcap=30.0,
        activation="gelu",
        post_norms=True,
        tie_embeddings=True,
        emb_scale="sqrt_d",
        rope_theta=10_000.0,
    )
