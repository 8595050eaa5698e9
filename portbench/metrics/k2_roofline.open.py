"""k2_roofline.open: ``k2_roofline`` in the open-loop cell, where it moves the
problems' latency: the offered load fixes the tokens per second there."""
from portbench.metrics.k2_roofline import read  # noqa: F401
