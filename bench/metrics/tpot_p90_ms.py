"""tpot_p90_ms: the 90th percentile of time per output token over the
requests that finished in the window with their first token in it too:
(device completion of the last token's step - that of the first) /
(tokens - 1)."""
from bench.stats import percentile


def read(run):
    T = run.window_s
    tpot = [(r.last.t - r.first.t) / (r.n_out - 1) for r in run.finished
            if r.first.t is not None and r.last.t <= T and r.n_out > 1]
    p = percentile(tpot, 90)
    return None if p is None else p * 1e3
