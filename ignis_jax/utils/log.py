"""Leveled logger (src/runtime/Logger.{h,cpp}, log/ equivalents).

API mirrors IG_LOG semantics: leveled messages (debug/info/warning/error/
fatal), ANSI colors on ttys, optional file listener, quiet mode.  Python's
`warnings` channel (used by loaders for degrade-gracefully paths) is
bridged so `-q/-v` flags affect everything.

    from ignis_jax.utils.log import logger
    logger.info("loading scene %s", path)
    logger.set_verbosity("debug")
    logger.add_file_listener("render.log")
"""

from __future__ import annotations

import os
import sys
import time

L_DEBUG, L_INFO, L_WARNING, L_ERROR, L_FATAL = range(5)
_NAMES = {"debug": L_DEBUG, "info": L_INFO, "warning": L_WARNING,
          "error": L_ERROR, "fatal": L_FATAL}
_TAGS = {L_DEBUG: ("[DEBUG]", "\x1b[90m"), L_INFO: ("[INFO ]", ""),
         L_WARNING: ("[WARN ]", "\x1b[33m"), L_ERROR: ("[ERROR]", "\x1b[31m"),
         L_FATAL: ("[FATAL]", "\x1b[1;31m")}


class Logger:
    def __init__(self):
        env = os.environ.get("IGNIS_LOG", "info").lower()
        self.verbosity = _NAMES.get(env, L_INFO)
        self.quiet = False
        self._files: list = []
        self._color = sys.stderr.isatty()

    def set_verbosity(self, level):
        self.verbosity = (_NAMES[level.lower()]
                          if isinstance(level, str) else int(level))

    def set_quiet(self, q: bool):
        self.quiet = bool(q)

    def add_file_listener(self, path):
        self._files.append(open(path, "a"))

    def _emit(self, level, msg, *fmt):
        if fmt:
            msg = msg % fmt
        tag, color = _TAGS[level]
        stamp = time.strftime("%H:%M:%S")
        line = f"{stamp} {tag} {msg}"
        if not self.quiet and level >= self.verbosity:
            if self._color and color:
                sys.stderr.write(f"{color}{line}\x1b[0m\n")
            else:
                sys.stderr.write(line + "\n")
        for f in self._files:
            f.write(line + "\n")
            f.flush()

    def debug(self, msg, *fmt):
        self._emit(L_DEBUG, msg, *fmt)

    def info(self, msg, *fmt):
        self._emit(L_INFO, msg, *fmt)

    def warning(self, msg, *fmt):
        self._emit(L_WARNING, msg, *fmt)

    def error(self, msg, *fmt):
        self._emit(L_ERROR, msg, *fmt)

    def fatal(self, msg, *fmt):
        self._emit(L_FATAL, msg, *fmt)


logger = Logger()
