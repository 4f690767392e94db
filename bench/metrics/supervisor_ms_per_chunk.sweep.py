"""supervisor_ms_per_chunk.sweep: host ms a chunk in run_supervised outside run_chunk."""

from bench.readers import supervisor_ms_per_chunk as read  # noqa: F401
