"""neighbor_kernel_roofline.dataset: the neighbour kernel's share of its roofline, in %."""

from bench.readers import neighbor_kernel_roofline as read  # noqa: F401
