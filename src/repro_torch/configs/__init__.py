"""Architectures the port serves: every architecture of the reference.
Importing this package populates the registry."""

from repro_torch.configs import (  # noqa: F401
    deepseek_v2_236b,
    gemma2_2b,
    gemma2_9b,
    minicpm3_4b,
    olmoe_1b_7b,
    qwen2_vl_2b,
    qwen15_05b,
    recurrentgemma_2b,
    rwkv6_3b,
    whisper_large_v3,
)

ALL_ARCHS = ["gemma2-9b", "minicpm3-4b", "gemma2-2b", "qwen1.5-0.5b",
             "olmoe-1b-7b", "deepseek-v2-236b", "recurrentgemma-2b",
             "whisper-large-v3", "qwen2-vl-2b", "rwkv6-3b"]
