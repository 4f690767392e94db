"""device_idle_share.sweep: the traced window's idle share, in %."""

from bench.readers import device_idle_share as read  # noqa: F401
