"""device_idle_share.open: ``device_idle_share`` in the open-loop cell, where it moves the
problems' latency: the offered load fixes the tokens per second there."""
from portbench.metrics.device_idle_share import read  # noqa: F401
