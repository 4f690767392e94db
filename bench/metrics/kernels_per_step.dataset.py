"""kernels_per_step.dataset: device operations a simulated step."""

from bench.readers import kernels_per_step as read  # noqa: F401
