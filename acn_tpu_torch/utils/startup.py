"""Startup watchdog: bound the time from process start to the training loop.

Port of ``acn_tpu/utils/startup.py``. ``arm`` starts a daemon thread that
exits the process with code 43 unless ``mark_ready`` is called within the
timeout; the training loop calls ``mark_ready`` once its own watchdog (exit
42) is armed, so a supervisor can tell a stuck start from a stuck loop.
"""

from __future__ import annotations

import os
import threading
import time

_STATE = {"ready": False, "armed": False}


def mark_ready() -> None:
    """Disarm the startup watchdog: the process reached a supervised phase."""
    _STATE["ready"] = True


def arm(timeout_s: float, what: str = "startup", poll_s: float = 15.0) -> None:
    """Arm the watchdog once per process; re-arming is a no-op.
    ``timeout_s <= 0`` disables it."""
    if timeout_s <= 0 or _STATE["armed"]:
        return
    _STATE["armed"] = True
    t0 = time.monotonic()

    def _watch():
        while not _STATE["ready"]:
            time.sleep(poll_s)
            if not _STATE["ready"] and time.monotonic() - t0 > timeout_s:
                print(f"[startup-watchdog] {what} made no progress for "
                      f"{timeout_s:.0f}s — exiting 43 for supervisor relaunch",
                      flush=True)
                os._exit(43)

    threading.Thread(target=_watch, daemon=True, name="startup-watchdog").start()
