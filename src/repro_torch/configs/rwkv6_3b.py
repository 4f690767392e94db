"""RWKV-6 (Finch) 3B [arXiv:2404.05892; hf:RWKV/rwkv-6-world-3b].

32L d_model=2560 (attention-free), d_ff=8960, vocab=65536.
WKV6 recurrence with data-dependent decay, head_dim=64 (40 heads),
token-shift mixing, LayerNorm. Sub-quadratic (O(1) decode state).
"""

from repro_torch.config.base import ModelConfig, register_arch


@register_arch("rwkv6-3b")
def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b",
        family="rwkv",
        n_layers=32,
        d_model=2560,
        n_heads=40,
        n_kv_heads=40,
        head_dim=64,
        d_ff=8960,
        vocab_size=65_536,
        layer_pattern=("rwkv",),
        rwkv_head_dim=64,
        norm_kind="layernorm",
        sub_quadratic=True,
    )
