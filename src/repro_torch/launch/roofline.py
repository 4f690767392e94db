"""Roofline arithmetic at the H100 SXM's published rates, and the model
FLOPs convention (port of ``repro/launch/roofline.py``).

Terms, in seconds a device:

    compute    = FLOPs_per_device / peak_flops     (dense bf16 tensor peak)
    memory     = bytes_per_device / hbm_bw         (HBM bandwidth)
    collective = wire_bytes_per_device / link_bw   (one link direction)

The rates are keyword defaults, so a caller can state another part's:
989e12 FLOP/s dense bf16 and 3.35e12 B/s HBM3 (NVIDIA's H100 SXM data
sheet, at its 700 W limit), 450e9 B/s NVLink 4 a direction (900 GB/s
bidirectional, the same sheet). ``model_flops`` is 6·N·D (train) or
2·N·D (prefill, decode) with N the active non-embedding parameters
(:func:`param_counts`); its ratio to the counted FLOPs shows how much of
the computed work is the model's (full remat: at most 0.75 in training).
"""

from __future__ import annotations

from repro_torch.config.base import ModelConfig, ShapeConfig

PEAK_FLOPS = 989e12      # dense bf16 FLOP/s, H100 SXM
HBM_BW = 3.35e12         # HBM3 bytes/s, H100 SXM
LINK_BW = 450e9          # NVLink 4 bytes/s, one direction


def roofline_report(
    *,
    flops_per_device: float,
    bytes_per_device: float,
    wire_bytes_per_device: float,
    n_devices: int,
    model_flops_global: float,
    peak_flops: float = PEAK_FLOPS,
    hbm_bw: float = HBM_BW,
    link_bw: float = LINK_BW,
) -> dict:
    compute_s = flops_per_device / peak_flops
    memory_s = bytes_per_device / hbm_bw
    collective_s = wire_bytes_per_device / link_bw
    terms = {
        "compute": compute_s, "memory": memory_s, "collective": collective_s
    }
    dominant = max(terms, key=terms.get)
    total_flops = flops_per_device * n_devices
    useful = model_flops_global / total_flops if total_flops > 0 else 0.0
    bound = max(compute_s, memory_s, collective_s)
    # fraction of roofline: the model's useful compute time over the
    # dominant term
    model_compute_s = (
        model_flops_global / n_devices / peak_flops if n_devices else 0.0
    )
    return {
        "compute_s": compute_s,
        "memory_s": memory_s,
        "collective_s": collective_s,
        "dominant": dominant,
        "useful_flops_ratio": useful,
        "model_compute_s_per_device": model_compute_s,
        "roofline_fraction": (model_compute_s / bound) if bound > 0 else 0.0,
        "arithmetic_intensity": (
            flops_per_device / bytes_per_device if bytes_per_device else 0.0
        ),
    }


def wire_bytes(op: str, payload_bytes: float, group: int) -> float:
    """Bytes one device sends for a collective over ``group`` devices, by
    the ring formulas (``payload_bytes``: the output of an all-gather or an
    all-to-all, the input of a reduce-scatter, the buffer of an all-reduce
    or a permute)."""
    frac = (group - 1) / max(group, 1)
    if op in ("all-gather", "reduce-scatter", "all-to-all"):
        return payload_bytes * frac
    if op == "all-reduce":           # a reduce-scatter, then an all-gather
        return 2.0 * payload_bytes * frac
    if op == "collective-permute":   # the whole buffer one hop
        return float(payload_bytes)
    raise ValueError(f"unknown collective {op!r}")


# --------------------------------------------------------------------------
# MODEL_FLOPS
# --------------------------------------------------------------------------

def param_counts(cfg: ModelConfig) -> dict[str, float]:
    """Analytic total + active param counts (embeddings excluded from the
    6·N·D convention; MoE active = shared + top_k experts)."""
    d = cfg.d_model
    n_attn_per_layer = 0.0
    if cfg.use_mla:
        dn, dr, dv = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim
        h = cfg.n_heads
        q = (
            d * cfg.q_lora_rank + cfg.q_lora_rank * h * (dn + dr)
            if cfg.q_lora_rank
            else d * h * (dn + dr)
        )
        kv = d * (cfg.kv_lora_rank + dr) + cfg.kv_lora_rank * h * (dn + dv)
        o = h * dv * d
        n_attn_per_layer = q + kv + o
    else:
        n_attn_per_layer = (
            d * cfg.n_heads * cfg.head_dim * 2
            + d * cfg.n_kv_heads * cfg.head_dim * 2
        )

    def ffn_params(m):
        return 3 * d * m

    n_layers = cfg.n_layers
    total = 0.0
    active = 0.0
    for i in range(n_layers):
        kind = cfg.layer_kind(i)
        if kind == "recurrent":
            w = cfg.lru_width
            hd = w // cfg.n_heads
            mix = 2 * d * w + cfg.conv_width * w + 2 * cfg.n_heads * hd * hd \
                + w * d
            total += mix
            active += mix
        elif kind == "rwkv":
            mix = 4 * d * d + d * d + 2 * d * 64  # r,k,v,g,o + decay lora
            cm = 2 * d * cfg.d_ff + d * d
            total += mix + cm
            active += mix + cm
            continue  # rwkv blocks carry their own ffn (channel mix)
        else:
            total += n_attn_per_layer
            active += n_attn_per_layer
        # FFN / MoE
        if cfg.n_experts > 0 and i >= cfg.first_dense_layers:
            e_p = ffn_params(cfg.moe_d_ff)
            total += cfg.n_experts * e_p + d * cfg.n_experts
            active += (cfg.top_k + cfg.n_shared_experts) * e_p
        elif kind != "rwkv":
            m = cfg.dense_d_ff if (
                cfg.n_experts > 0 and i < cfg.first_dense_layers
            ) else cfg.d_ff
            total += ffn_params(m)
            active += ffn_params(m)
    if cfg.is_encdec:
        enc = cfg.n_enc_layers * (n_attn_per_layer + ffn_params(cfg.d_ff))
        cross = cfg.n_layers * n_attn_per_layer
        total += enc + cross
        active += enc + cross
    emb = cfg.vocab_size * d * (1 if cfg.tie_embeddings else 2)
    return {
        "total": total, "active": active, "embedding": emb,
        "total_with_emb": total + emb,
    }


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """6·N·D (train) or 2·N·D (prefill/decode), N = active non-emb params."""
    n = param_counts(cfg)["active"]
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    tokens = shape.global_batch * 1
    return 2.0 * n * tokens
