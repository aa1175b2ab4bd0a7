"""parallel.order_ms (ms): device time of the row barrier before kernel
#11 (``_order_before``'s NCCL all-reduce of a 32-bit word, whose kernel
NCCL names ``ncclDevKernel_AllReduce_Sum_u32_*``), per step, on each rank;
the result is the slowest rank's.  The kernel runs until the last rank of
the row reaches it, so this is the rank's wait for the row."""

NCCL = "ncclDevKernel_AllReduce_Sum_"


def read(tr):
    from portbench.trace import kernel_ident
    d = [dur for name, cat, _, dur in tr.device
         if cat == "kernel" and kernel_ident(name).startswith(NCCL + "u32_")]
    if not d or tr.steps == 0:
        return None
    return 1e-3 * sum(d) / tr.steps


combine = max
