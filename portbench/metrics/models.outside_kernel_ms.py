"""models.outside_kernel_ms (ms): a QAM step's wall time (the
``portbench.step`` span, which ends when the step's output is ready)
minus kernel #6's device time, per step of the traced window: the state
packing, output unpacking, launches and waits that ``DecisionDemodSB.step``
adds around its kernel."""


def read(tr):
    kern, count = tr.kernel_seconds("demod_sb_fused_kernel")
    wall, steps = tr.span_seconds("portbench.step")
    if count == 0 or steps == 0:
        return None
    return 1e3 * (wall - kern) / steps
