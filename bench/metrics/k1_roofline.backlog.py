"""k1_roofline.backlog: k1_roofline in the backlog cells, where it
moves output_tokens_per_s."""
from bench.metrics.k1_roofline import read  # noqa: F401
