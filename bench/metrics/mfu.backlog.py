"""mfu.backlog: mfu in the backlog cells, where it moves
output_tokens_per_s."""
from bench.metrics.mfu import read  # noqa: F401
