"""parallel.all_reduce_ms (ms): device time of the row's sum (the NCCL
all-reduce of the ranks' float32 partial spectra,
``ncclDevKernel_AllReduce_Sum_f32_*``), per step, on each rank; the result
is the slowest rank's."""

NCCL = "ncclDevKernel_AllReduce_Sum_"


def read(tr):
    from portbench.trace import kernel_ident
    d = [dur for name, cat, _, dur in tr.device
         if cat == "kernel" and kernel_ident(name).startswith(NCCL + "f32_")]
    if not d or tr.steps == 0:
        return None
    return 1e-3 * sum(d) / tr.steps


combine = max
