"""instance_steps_per_s.dataset: the recorded dataset sweep's rate on the host clock, instance-steps/s."""

from bench.readers import instance_steps_per_s as read  # noqa: F401
