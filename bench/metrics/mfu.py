"""mfu: the model FLOPs the traced slice's steps need (bench.flops:
real fed tokens only, no padding) over the slice's device busy seconds
at the card's bf16 peak, in percent."""
from bench import flops


def read(run):
    if run.slice is None or run.peak is None or not run.slice_steps:
        return None
    busy = run.slice.busy_s()
    if busy <= 0:
        return None
    work = sum(flops.step_flops(run.cell.config, s.feeds)
               for s in run.slice_steps)
    return 100.0 * work / (busy * run.peak["bf16_flop_per_s"])
