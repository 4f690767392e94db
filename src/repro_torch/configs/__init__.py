"""Architectures the port serves. Importing this package populates the
registry; the other architectures of the reference come with the slices
that port their layer kinds (ROADMAP queue 1)."""

from repro_torch.configs import (  # noqa: F401
    deepseek_v2_236b,
    gemma2_2b,
    minicpm3_4b,
    olmoe_1b_7b,
    qwen15_05b,
    recurrentgemma_2b,
    rwkv6_3b,
)

ALL_ARCHS = ["minicpm3-4b", "gemma2-2b", "qwen1.5-0.5b", "olmoe-1b-7b",
             "deepseek-v2-236b", "recurrentgemma-2b", "rwkv6-3b"]
