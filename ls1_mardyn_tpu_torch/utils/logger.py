"""Process-aware logger.

The role of Log::Logger (src/utils/Logger.h:69-116):
leveled, timestamped, optional per-process logfiles.  Multi-process
rank handling is not needed: one process drives one device.
"""

from __future__ import annotations

import logging
import sys

_LEVELS = {
    "NONE": logging.CRITICAL + 10,
    "FATAL": logging.CRITICAL,
    "ERROR": logging.ERROR,
    "WARNING": logging.WARNING,
    "INFO": logging.INFO,
    "DEBUG": logging.DEBUG,
    "ALL": 1,
}

global_log = logging.getLogger("ls1_torch")


def init_logger(verbose: bool = False, logfile: str = None):
    global_log.handlers.clear()
    h = (
        logging.FileHandler(logfile)
        if logfile
        else logging.StreamHandler(sys.stdout)
    )
    h.setFormatter(
        logging.Formatter("%(asctime)s %(levelname)-7s [%(name)s] %(message)s")
    )
    global_log.addHandler(h)
    global_log.setLevel(logging.DEBUG if verbose else logging.INFO)
    return global_log


def set_log_level(name: str):
    global_log.setLevel(_LEVELS.get(name.upper(), logging.INFO))
