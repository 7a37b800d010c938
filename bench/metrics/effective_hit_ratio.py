"""effective_hit_ratio: the store's block lookups over the window that hit
a block whose whole chain was resident (the paper's effective hit), over
all block lookups (CacheMetrics effective_hits / accesses)."""


def read(run):
    accesses = run.delta("accesses")
    return run.delta("effective_hits") / accesses if accesses else None
