"""Gemma-2 2B [arXiv:2408.00118; hf:google/gemma-2-2b].

26L d_model=2304 8H (GQA kv=4, head_dim=256) d_ff=9216 vocab=256000.
Alternating local (window 4096) and global layers, attention logit softcap
50, final logit softcap 30.
"""

from repro_torch.config.base import ModelConfig, register_arch


@register_arch("gemma2-2b")
def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-2b",
        family="dense",
        n_layers=26,
        d_model=2304,
        n_heads=8,
        n_kv_heads=4,
        head_dim=256,
        d_ff=9216,
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
