"""Host lock between a long training run on the card and other entry points.

A copy of ``head_detector_tpu/hostlock.py``'s protocol (the port imports
nothing of the JAX package):

* the trainer writes its PID into ``/tmp/hdt_campaign.lock``, the
  reference's path whatever ``TMPDIR`` says, so that a run of either
  package sees the other's lock (``HDT_CAMPAIGN_LOCK`` overrides the path),
  for the duration of any training run that is not on the CPU, and removes
  it on exit;
* a benchmark waits a bounded time for the lock to clear
  (``wait_until_free``), then proceeds and records whether its numbers were
  taken beside a run.

A lock whose holder is dead is stale: it is ignored and removed.
"""

from __future__ import annotations

import os
import time

DEFAULT_LOCK_PATH = "/tmp/hdt_campaign.lock"


def lock_path() -> str:
    return os.environ.get("HDT_CAMPAIGN_LOCK", DEFAULT_LOCK_PATH)


def _holder_pid() -> int:
    """PID in the lockfile, or 0 if absent or unreadable."""
    try:
        with open(lock_path()) as f:
            return int(f.read().strip() or "0")
    except (OSError, ValueError):
        return 0


def _pid_alive(pid: int) -> bool:
    if pid <= 0:
        return False
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def campaign_active() -> bool:
    """True while a live training process holds the lock."""
    pid = _holder_pid()
    if pid and not _pid_alive(pid):
        try:  # stale lock of a killed run: clean it up
            os.unlink(lock_path())
        except OSError:
            pass
        return False
    return bool(pid)


def acquire(pid: int | None = None) -> None:
    """Record this process as the running campaign (an overwrite: runs on one
    card are serialised by construction)."""
    try:
        with open(lock_path(), "w") as f:
            f.write(str(pid or os.getpid()))
    except OSError:
        pass


def release() -> None:
    if _holder_pid() == os.getpid():
        try:
            os.unlink(lock_path())
        except OSError:
            pass


def wait_until_free(max_wait_s: float, poll_s: float = 10.0) -> bool:
    """Block until no live process holds the lock, up to ``max_wait_s``
    seconds, polling every ``poll_s``.  Returns True when the lock is still
    held at the deadline (the caller's numbers are taken beside a run)."""
    deadline = time.monotonic() + max_wait_s
    while campaign_active():
        if time.monotonic() >= deadline:
            return True
        time.sleep(poll_s)
    return False
