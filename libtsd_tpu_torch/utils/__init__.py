from . import convert, geometry, monitor, testing, timedate, wav  # noqa: F401
