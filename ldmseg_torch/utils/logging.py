"""Stdout tee logger (own copy of ``ldmseg_tpu/utils/logging.py``).

Reference: ldmseg/utils/utils.py:202-237 (``Logger``): stdout is mirrored
to a per-process logfile; non-primary processes can be silenced
(``quiet``).
"""

from __future__ import annotations

import os
import sys


class Logger:
    def __init__(self, fpath: str | None = None, quiet: bool = False):
        self.console = sys.stdout
        self.file = None
        self.quiet = quiet
        if fpath is not None:
            os.makedirs(os.path.dirname(fpath) or ".", exist_ok=True)
            self.file = open(fpath, "w")

    def install(self):
        sys.stdout = self
        return self

    def uninstall(self):
        sys.stdout = self.console

    def write(self, msg):
        if not self.quiet:
            self.console.write(msg)
        if self.file is not None:
            self.file.write(msg)

    def flush(self):
        self.console.flush()
        if self.file is not None:
            self.file.flush()
            os.fsync(self.file.fileno())

    def close(self):
        self.uninstall()
        if self.file is not None:
            self.file.close()
