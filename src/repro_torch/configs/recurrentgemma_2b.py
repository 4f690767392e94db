"""RecurrentGemma-2B (Griffin) [arXiv:2402.19427; hf:google/recurrentgemma-2b].

26L d_model=2560 10H (MQA kv=1, head_dim=256) d_ff=7680 vocab=256000.
Layer pattern: (recurrent, recurrent, local-attention) with a 2048 window;
RG-LRU recurrence width 2560, temporal conv width 4. Sub-quadratic.
"""

from repro_torch.config.base import ModelConfig, register_arch


@register_arch("recurrentgemma-2b")
def config() -> ModelConfig:
    return ModelConfig(
        name="recurrentgemma-2b",
        family="hybrid",
        n_layers=26,
        d_model=2560,
        n_heads=10,
        n_kv_heads=1,
        head_dim=256,
        d_ff=7680,
        vocab_size=256_000,
        layer_pattern=("recurrent", "recurrent", "local"),
        window=2048,
        lru_width=2560,
        conv_width=4,
        activation="gelu",
        tie_embeddings=True,
        emb_scale="sqrt_d",
        rope_theta=10_000.0,
        sub_quadratic=True,
    )
