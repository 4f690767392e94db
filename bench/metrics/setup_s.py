"""setup_s: the set-up's seconds, compilation included."""

from bench.readers import setup_s as read  # noqa: F401
