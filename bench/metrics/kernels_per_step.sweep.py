"""kernels_per_step.sweep: device operations a simulated step."""

from bench.readers import kernels_per_step as read  # noqa: F401
