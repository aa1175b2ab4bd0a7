"""demod_sb_fused_roofline (%): kernel #6's share of its roofline, the least
time of one step's launch (``roofline/demod_sb_fused.py``) over the mean
device time of its launches in the traced window."""
from portbench.reference.qam import layout
from portbench.roofline import demod_sb_fused


def read(tr):
    total, count = tr.kernel_seconds("demod_sb_fused_kernel")
    if count == 0:
        return None
    t, c = tr.cell.traffic, tr.cell.config
    n = t["nsym"] * c["osf"]
    xoff = layout(c["osf"], c["S"], c["itrp_taps"], n)["XOFF"]
    least, _ = demod_sb_fused.least_seconds(
        t["channels"], n, xoff, c["osf"], c["mf_taps"], c["itrp_taps"])
    return 100.0 * least * count / total
