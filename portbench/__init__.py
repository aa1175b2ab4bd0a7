"""The benchmark of ``libtsd_tpu_torch``, the PyTorch and CUDA port.

Everything a cell needs is found by name from ``BENCHMARK.json``:
``configs/<config>.json``, ``traffic/<traffic>.json``, ``paths/<path>.py``,
``reference/<path>.py``, ``metrics/<metric>.py`` and
``roofline/<kernel>.py``.  See ``README.md``.
"""
