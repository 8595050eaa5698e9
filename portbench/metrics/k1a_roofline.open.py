"""k1a_roofline.open: ``k1a_roofline`` in the open-loop cell, where it moves the
problems' latency: the offered load fixes the tokens per second there."""
from portbench.metrics.k1a_roofline import read  # noqa: F401
