"""Logging facility: leveled messages with a pluggable global sink.

Parity: core/include/tsd/commun.hpp:41-138 (msg / msg_avert / msg_erreur
macros with file/line, pluggable get_logger()), sink tsd_log_msg
(core/src/tsd.cc:45).
"""
from __future__ import annotations

import sys
import os
import time
from typing import Callable, Optional

__all__ = ["msg", "msg_warn", "msg_error", "set_logger", "LogRecord"]


class LogRecord:
    def __init__(self, level: str, text: str, file: str, line: int):
        self.level = level
        self.text = text
        self.file = file
        self.line = line
        self.time = time.time()

    def __str__(self):
        tag = {"info": " ", "warn": "W", "error": "E"}[self.level]
        return f"[{tag}] {os.path.basename(self.file)}:{self.line}: {self.text}"


def _default_sink(rec: LogRecord):
    import sys
    out = sys.stderr if rec.level == "error" else sys.stdout
    print(str(rec), file=out)


_sink: Callable[[LogRecord], None] = _default_sink
_min_level = "warn"  # default: quiet info (library code calls msg freely)
_ORDER = {"info": 0, "warn": 1, "error": 2}


def set_logger(sink: Optional[Callable[[LogRecord], None]] = None,
               min_level: str = "info"):
    """Install a global log sink (parity: get_logger hook)."""
    global _sink, _min_level
    _sink = sink or _default_sink
    _min_level = min_level


def _emit(level: str, text: str):
    if _ORDER[level] < _ORDER[_min_level]:
        return
    # sys._getframe walks two frames; inspect.stack() would materialize
    # FrameInfo (incl. source lookup) for the ENTIRE stack per message
    fr = sys._getframe(2)
    _sink(LogRecord(level, text, fr.f_code.co_filename, fr.f_lineno))


def msg(fmt: str, *args):
    """Info message (parity: msg)."""
    _emit("info", fmt.format(*args) if args else fmt)


def msg_warn(fmt: str, *args):
    """Warning (parity: msg_avert)."""
    _emit("warn", fmt.format(*args) if args else fmt)


def msg_error(fmt: str, *args):
    """Error (parity: msg_erreur)."""
    _emit("error", fmt.format(*args) if args else fmt)
