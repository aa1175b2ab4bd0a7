from . import convert  # noqa: F401
