"""roofline_mfu.sweep: the whole sim step's share of the roofline, in %."""

from bench.readers import roofline_mfu as read  # noqa: F401
