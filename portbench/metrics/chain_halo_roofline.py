"""chain_halo_roofline (%): kernel #11's share of its roofline on one
shard (``roofline/chain_halo.py``), on each rank over the mean device time
of its launches; the result is the ranks' mean."""
from portbench.roofline import chain_halo


def read(tr):
    total, count = tr.kernel_seconds("chain_halo_kernel")
    if count == 0:
        return None
    t, c = tr.cell.traffic, tr.cell.config
    least, _ = chain_halo.least_seconds(t["channels"], t["block"],
                                        c["taps"], c["precision"])
    return 100.0 * least * count / total
