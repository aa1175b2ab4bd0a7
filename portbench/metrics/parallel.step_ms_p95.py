"""parallel.step_ms_p95 (ms): the 95th percentile of a sharded step's wall
time on each rank (the ``portbench.step`` span: the block handed to the
port until the row's spectra are ready, the harness's wait included); the
result is the slowest rank's.  It stands in for ``step_ms_p95`` on a cell
across cards, whose hosts stall too often for a bound on that tail."""
import statistics


def read(tr):
    d = [dur for n, _, dur in tr.spans if n == "portbench.step"]
    if len(d) < 2:
        return None
    return statistics.quantiles(d, n=100)[94] / 1e3


combine = max
