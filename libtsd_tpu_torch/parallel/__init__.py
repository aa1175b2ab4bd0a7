"""The parallel layer: a single-controller ("chan", "time") mesh, the halo
exchange, the sharded fused chain and FM receiver, and the multi-process
launch path (``launch``).  See ``mesh`` for the model."""
from .mesh import Mesh, gather, make_mesh, shard  # noqa: F401
from .halo import (halo_exchange_left, iir_time_sharded,  # noqa: F401
                   sharded_chain, sharded_fir)
from .chain import sharded_fir_periodogram4096  # noqa: F401
from .fm import sharded_fm_receiver  # noqa: F401

__all__ = ["Mesh", "make_mesh", "shard", "gather", "halo_exchange_left",
           "sharded_fir", "sharded_chain", "iir_time_sharded",
           "sharded_fir_periodogram4096", "sharded_fm_receiver"]
