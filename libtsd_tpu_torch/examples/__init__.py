"""Twins of ``examples/`` on the port, run as ``python -m
libtsd_tpu_torch.examples.<name>``; each runs on the card unless it is
given ``--device cpu``."""
