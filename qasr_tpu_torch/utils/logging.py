"""Logging singleton (port of qasr_tpu/utils/logging.py, host only).

A process-wide logger with env-controlled level / coloring
(``QASR_LOG_LEVEL``, ``QASR_LOG_COLOR``), memory-buffered records flushed
into a run file once the experiment directory is known (``ExpManager``),
and once-only dedup (``once=True``).
"""
from __future__ import annotations

import logging as _pylog
import os
import sys
from logging.handlers import MemoryHandler
from typing import Optional, Set


class _OnceFilter(_pylog.Filter):
    """LogMode.ONCE: drop repeated identical messages."""

    def __init__(self):
        super().__init__()
        self.seen: Set[str] = set()

    def filter(self, record: _pylog.LogRecord) -> bool:
        if getattr(record, "once", False):
            key = f"{record.levelno}:{record.getMessage()}"
            if key in self.seen:
                return False
            self.seen.add(key)
        return True


class Logger:
    _instance: Optional["Logger"] = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
            cls._instance._setup()
        return cls._instance

    def _setup(self):
        self._logger = _pylog.getLogger("qasr_tpu_torch")
        self._logger.propagate = False
        level = os.environ.get("QASR_LOG_LEVEL", "INFO").upper()
        self._logger.setLevel(getattr(_pylog, level, _pylog.INFO))
        use_color = os.environ.get("QASR_LOG_COLOR", "1") not in ("0", "false")
        fmt = "[QASR %(levelname)s %(asctime)s %(module)s:%(lineno)d] %(message)s"
        if use_color and sys.stderr.isatty():
            fmt = "\033[96m[QASR %(levelname)s]\033[0m %(asctime)s %(module)s:%(lineno)d %(message)s"
        h = _pylog.StreamHandler(sys.stderr)
        h.setFormatter(_pylog.Formatter(fmt, datefmt="%H:%M:%S"))
        self._logger.addHandler(h)
        self._logger.addFilter(_OnceFilter())
        # memory buffer: flushed to a file when add_file_handler is called
        self._mem = MemoryHandler(10000, flushLevel=_pylog.CRITICAL + 1)
        self._logger.addHandler(self._mem)

    def add_file_handler(self, path: str) -> None:
        """Flush buffered records into a per-run log file
        (exp_manager-style, nemo_logging buffered handlers)."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        fh = _pylog.FileHandler(path)
        fh.setFormatter(_pylog.Formatter(
            "[%(levelname)s %(asctime)s %(module)s:%(lineno)d] %(message)s"))
        self._mem.setTarget(fh)
        self._mem.flush()
        self._logger.addHandler(fh)

    def set_verbosity(self, level) -> None:
        self._logger.setLevel(level)

    def get_verbosity(self):
        return self._logger.level

    # passthroughs (support once=True keyword like LogMode.ONCE)
    def _log(self, fn, msg, *args, once=False):
        fn(msg, *args, extra={"once": once}, stacklevel=3)

    def debug(self, msg, *args, once=False):
        self._log(self._logger.debug, msg, *args, once=once)

    def info(self, msg, *args, once=False):
        self._log(self._logger.info, msg, *args, once=once)

    def warning(self, msg, *args, once=False):
        self._log(self._logger.warning, msg, *args, once=once)

    def error(self, msg, *args, once=False):
        self._log(self._logger.error, msg, *args, once=once)

    WARNING = _pylog.WARNING
    INFO = _pylog.INFO
    DEBUG = _pylog.DEBUG


logging = Logger()
