"""device_ms_per_step: device ms a simulated step of the whole batch takes, from the trace."""

from bench.readers import device_ms_per_step as read  # noqa: F401
