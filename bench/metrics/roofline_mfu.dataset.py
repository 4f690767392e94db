"""roofline_mfu.dataset: the whole sim step's share of the roofline over its device time, in %."""

from bench.readers import roofline_mfu_device as read  # noqa: F401
