"""k1_roofline: K1's (the paged-attention kernel's) least time over its
device time in the traced slice, in percent. The least time of a step's
calls is max(bytes / HBM bandwidth, FLOPs / bf16 peak) of what the step's
feeds need (bench.flops.k1_step_cost); the device time sums the records
of K1's kernels, by the program's kernel names."""
from bench import flops

KERNELS = ("paged_mma_kernel", "paged_simt_kernel", "paged_merge_kernel")


def read(run):
    if run.slice is None or run.peak is None or not run.slice_steps:
        return None
    spent = run.slice.time_by_name(*KERNELS)
    if spent <= 0:
        return None
    bound = sum(flops.roofline_s(*flops.k1_step_cost(run.cell.config,
                                                     s.feeds), run.peak)
                for s in run.slice_steps)
    return 100.0 * bound / spent
