"""ttft_p90_ms: the 90th percentile of time to first token over every
request due in the window, from its scheduled arrival to the device
completion of the step that computed its first token; a request without
one by the window's end counts at its age then."""
from bench.stats import percentile


def read(run):
    T = run.window_s
    ttft = [(min(r.first.t, T) if r.first is not None else T) - r.arrival
            for r in run.requests]
    p = percentile(ttft, 90)
    return None if p is None else p * 1e3
