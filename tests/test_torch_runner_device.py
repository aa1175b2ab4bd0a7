"""Where the port's ``StreamRunner`` runs a block that holds no tensor.

Such a block (a ``Decimator``: an integer and no buffer) names no device.
The runner used to stage it on the CPU without a word; it now stages it on
the card (``config.device``), which raises where there is none, unless
the caller passes ``device=``.  On the CPU the stream is unchanged.
No JAX call: the runner's contract is the port's own."""
import numpy as np
import pytest
import torch

import torch_compare  # noqa: F401  (thread caps)
from libtsd_tpu_torch.io.runner import StreamRunner
from libtsd_tpu_torch.ops.filter_rt import Decimator, Fir


def _x(n=4096, seed=3):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(n) + 1j * rng.standard_normal(n)).astype(
        np.complex64)


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine "
                    "without a CUDA device")
def test_tensorless_block_raises_without_a_card():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        StreamRunner(Decimator(4), block_len=512)


@pytest.mark.parametrize("chunk", [333, 512, 4096])
def test_tensorless_block_on_the_cpu_when_asked(chunk):
    """device="cpu": the same output as one step over the whole signal,
    whatever the push size."""
    blk = Decimator(4)
    x = _x()
    r = StreamRunner(blk, block_len=512, device="cpu")
    assert r.device == torch.device("cpu")
    for off in range(0, len(x), chunk):
        r.push(x[off:off + chunk])
    y = r.run([])
    assert np.array_equal(y, blk.apply(torch.as_tensor(x)).numpy())


def test_block_with_buffers_keeps_their_device():
    """A block that holds tensors runs where they are, as before; an
    explicit device= names the same place."""
    h = np.hanning(31)
    blk = Fir.create(h, device="cpu")
    x = _x(2048)
    ya = StreamRunner(blk, block_len=256).run([x])
    yb = StreamRunner(blk, block_len=256, device="cpu").run([x])
    assert np.array_equal(ya, yb)
    one = blk.apply(torch.as_tensor(x)).numpy()
    assert np.abs(ya - one).max() <= 1e-5 * np.abs(one).max()
