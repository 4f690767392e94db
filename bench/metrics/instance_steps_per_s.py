"""instance_steps_per_s: the merge study's rate, instance-steps/s."""

from bench.readers import instance_steps_per_s as read  # noqa: F401
