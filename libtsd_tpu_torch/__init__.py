"""libtsd-tpu, PyTorch/CUDA port: the JAX package ``libtsd_tpu`` carried to
PyTorch, with its Pallas TPU kernels rewritten by hand in CUDA C++ for
Hopper (``csrc/``, built by ``ops.kernels._build``).

This package imports ``torch`` and never ``jax`` or ``libtsd_tpu``.

Layout (the JAX package's, with ``ops/kernels/`` for ``ops/pallas/``):

* ``libtsd_tpu_torch.ops``    -- window, FIR and IIR design, the FIR and IIR
  runtime, FFT/PSD, resampling pieces, signals, random draws, and the
  kernels.
* ``libtsd_tpu_torch.models`` -- waveforms, modulator, carrier and clock
  recovery, the demodulators, BER tooling, the pattern detector, the frame
  transmitter and receiver, the analog modems, ``FmReceiver`` and
  ``Qam16Modem``.
* ``libtsd_tpu_torch.io``     -- ring buffer, re-blocking, IQ readers and
  the ``StreamRunner`` serving loop.
* ``libtsd_tpu_torch.utils``  -- conversion of JAX-package parameters and
  states, checkpoints, monitors, logging.
"""

from . import config
from .block import Block, Chain, chain, Identity, stream, pad_to_multiple

__version__ = "0.1.0"
