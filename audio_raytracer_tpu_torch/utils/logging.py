"""Zero-cost-when-off debug logging.

The reference's DebugLogger (Static Managers/DebugLogger.cs) strips log
calls at compile time behind the Enable_Debug_Logging define. Python
cannot strip calls; the next best thing is a module-level flag read once
(``AUDIO_RT_DEBUG_LOGGING``) and lazy formatting (a format string and
its arguments)."""

from __future__ import annotations

import os
import sys

ENABLED = os.environ.get("AUDIO_RT_DEBUG_LOGGING", "0") not in ("0", "", "false")


def log(fmt: str, *args) -> None:
    if ENABLED:
        print("[audio-rt] " + (fmt % args if args else fmt), file=sys.stderr)


def warn(fmt: str, *args) -> None:
    if ENABLED:
        print("[audio-rt:warn] " + (fmt % args if args else fmt),
              file=sys.stderr)


def error(fmt: str, *args) -> None:
    # Errors always print (DebugLogger.LogError is unconditional in-editor).
    print("[audio-rt:error] " + (fmt % args if args else fmt),
          file=sys.stderr)
