"""parallel.overhead_ms (ms): a sharded step's wall time (the
``portbench.step`` span, which ends when the row's spectra are ready)
minus kernel #11's device time, per step, on each rank; the result is the
slowest rank's: the halo slots, the row's all-reduce, the ordering
barrier, the launches and the waits for the other ranks."""


def read(tr):
    kern, count = tr.kernel_seconds("chain_halo_kernel")
    wall, steps = tr.span_seconds("portbench.step")
    if count == 0 or steps == 0:
        return None
    return 1e3 * (wall - kern) / steps


combine = max
