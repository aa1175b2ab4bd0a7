"""Host-side streaming I/O of the port: the ring buffer and re-blocker
(native ``streamio.cc`` through ctypes, numpy where it cannot load), IQ
sample converters and file reader, and the ``StreamRunner`` serving loop."""
from .streamio import (RingBuffer, Rebuffer, cs16_to_cf32, cu8_to_cf32,  # noqa: F401
                       deinterleave, interleave, native_available,
                       IqFileReader)
from .runner import StreamRunner  # noqa: F401
