"""Config system: frozen dataclasses + an architecture registry.

The port's copy of ``repro/config/base.py`` (``ModelConfig``,
``ShapeConfig`` and ``SHAPES``, ``TrainConfig``, ``ServeConfig``,
``MeshConfig`` and the registry). Field names, defaults and
:meth:`ModelConfig.reduced` are the reference's, so a reduced config here
has the same shapes as the reference's reduced config of the same
architecture.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str  # "dense" | "moe" | "hybrid" | "rwkv" | "encdec"
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int

    # ---- per-layer pattern: repeating cycle of layer kinds --------------
    # entries: "global" | "local" | "recurrent" | "rwkv"
    layer_pattern: tuple[str, ...] = ("global",)
    window: int = 0  # sliding-window size for "local" layers

    # ---- attention -------------------------------------------------------
    attn_logit_softcap: float = 0.0
    final_logit_softcap: float = 0.0
    qkv_bias: bool = False
    qk_norm: bool = False
    rope_theta: float = 10_000.0
    mrope_sections: tuple[int, ...] = ()  # qwen2-vl M-RoPE (t,h,w) half-dims

    # ---- MLA (deepseek-v2, minicpm3) --------------------------------------
    use_mla: bool = False
    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    # ---- FFN / MoE ---------------------------------------------------------
    activation: str = "silu"  # "silu" | "gelu"
    n_experts: int = 0
    n_shared_experts: int = 0
    top_k: int = 0
    moe_d_ff: int = 0
    first_dense_layers: int = 0  # deepseek-v2: leading dense layers
    dense_d_ff: int = 0          # d_ff of those leading dense layers
    capacity_factor: float = 1.25

    # ---- recurrent (RG-LRU) ------------------------------------------------
    lru_width: int = 0
    conv_width: int = 4

    # ---- rwkv --------------------------------------------------------------
    rwkv_head_dim: int = 64

    # ---- encoder-decoder (whisper) ------------------------------------------
    is_encdec: bool = False
    n_enc_layers: int = 0
    enc_ctx: int = 1500  # encoder memory length for decode cells

    # ---- frontends (stubs per assignment) -----------------------------------
    frontend: str = "none"  # "none" | "audio" | "vision"

    # ---- misc ----------------------------------------------------------------
    tie_embeddings: bool = False
    emb_scale: str = "none"  # "none" | "sqrt_d" | "const12"
    norm_eps: float = 1e-6
    post_norms: bool = False  # gemma2 sandwich norms
    norm_kind: str = "rmsnorm"  # "rmsnorm" | "layernorm"
    dtype: str = "bfloat16"
    sub_quadratic: bool = False  # eligible for long_500k decode

    # ------------------------------------------------------------------
    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def pattern_len(self) -> int:
        return len(self.layer_pattern)

    def layer_kind(self, i: int) -> str:
        return self.layer_pattern[i % self.pattern_len]

    def is_moe_layer(self, i: int) -> bool:
        return self.n_experts > 0 and i >= self.first_dense_layers

    def reduced(self, **overrides) -> "ModelConfig":
        """Smoke-test variant: same topology, tiny dimensions."""
        pat = len(self.layer_pattern)
        small = dict(
            n_layers=max(2 * pat, 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 4) if self.n_kv_heads > 1 else 1,
            head_dim=16,
            d_ff=128,
            vocab_size=256,
            window=min(self.window, 16) if self.window else 0,
            q_lora_rank=32 if self.q_lora_rank else 0,
            kv_lora_rank=16 if self.kv_lora_rank else 0,
            qk_nope_head_dim=8 if self.use_mla else 0,
            qk_rope_head_dim=8 if self.use_mla else 0,
            v_head_dim=16 if self.use_mla else 0,
            n_experts=min(self.n_experts, 8),
            n_shared_experts=min(self.n_shared_experts, 1),
            top_k=min(self.top_k, 2),
            moe_d_ff=32 if self.moe_d_ff else 0,
            dense_d_ff=128 if self.dense_d_ff else 0,
            first_dense_layers=min(self.first_dense_layers, 1),
            lru_width=64 if self.lru_width else 0,
            rwkv_head_dim=16,
            n_enc_layers=2 if self.is_encdec else 0,
            enc_ctx=8 if self.is_encdec else self.enc_ctx,
            mrope_sections=(2, 3, 3) if self.mrope_sections else (),
        )
        small.update(overrides)
        return dataclasses.replace(self, name=self.name + "-smoke", **small)


# --------------------------------------------------------------------------
# Shapes (assigned per-paper input-shape set)
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


# --------------------------------------------------------------------------
# Train / serve / mesh configuration
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class TrainConfig:
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1_000
    weight_decay: float = 0.1
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    grad_clip: float = 1.0
    schedule: str = "cosine"  # "cosine" | "linear" | "constant"
    microbatches: int = 1     # gradient-accumulation steps per update
    remat: str = "full"       # "none" | "full" | "dots"
    opt_state_dtype: str = "float32"
    z_loss: float = 0.0
    moe_aux_weight: float = 0.01
    seed: int = 0


@dataclass(frozen=True)
class ServeConfig:
    max_batch: int = 8
    max_seq: int = 2048
    prefill_chunk: int = 512
    temperature: float = 0.0
    seed: int = 0


@dataclass(frozen=True)
class MeshConfig:
    """A mesh's axis sizes and names, with no device behind it: the
    sharding rules and the dry run's memory plan read it
    (:func:`repro_torch.launch.mesh.make_abstract_mesh`)."""

    shape: tuple[int, ...] = (16, 16)
    axes: tuple[str, ...] = ("data", "model")

    @property
    def n_devices(self) -> int:
        n = 1
        for s in self.shape:
            n *= s
        return n


_REGISTRY: dict[str, Callable[[], ModelConfig]] = {}


def register_arch(arch_id: str):
    def deco(fn: Callable[[], ModelConfig]):
        _REGISTRY[arch_id] = fn
        return fn
    return deco


def get_arch(arch_id: str) -> ModelConfig:
    import repro_torch.configs  # noqa: F401  (populates the registry)

    if arch_id not in _REGISTRY:
        raise KeyError(
            f"unknown arch {arch_id!r}; available: {sorted(_REGISTRY)}"
        )
    return _REGISTRY[arch_id]()


def list_archs() -> list[str]:
    import repro_torch.configs  # noqa: F401

    return sorted(_REGISTRY)
