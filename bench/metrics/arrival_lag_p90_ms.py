"""arrival_lag_p90_ms: the load generator's lateness, the 90th percentile
of submit time - scheduled arrival over the requests due in the window
(one never submitted counts at its age at the window's end)."""
from bench.stats import percentile


def read(run):
    lag = [(r.submit if r.submit is not None else run.window_s) - r.arrival
           for r in run.requests]
    p = percentile(lag, 90)
    return None if p is None else p * 1e3
