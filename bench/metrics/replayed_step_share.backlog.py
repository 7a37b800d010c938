"""replayed_step_share.backlog: replayed_step_share in the backlog
cells, where it moves output_tokens_per_s."""
from bench.metrics.replayed_step_share import read  # noqa: F401
