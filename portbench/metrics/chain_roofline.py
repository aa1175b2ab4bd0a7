"""chain_roofline (%): kernel #3's share of its roofline, the least time of
one call (``roofline/chain.py``) over the mean device time of its launches
in the traced window."""
from portbench.roofline import chain


def read(tr):
    total, count = tr.kernel_seconds("chain_kernel")
    if count == 0:
        return None
    t, c = tr.cell.traffic, tr.cell.config
    least, _ = chain.least_seconds(t["channels"], t["block"], c["taps"],
                                   c["precision"])
    return 100.0 * least * count / total
