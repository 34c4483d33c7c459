"""Preemption handling (port of ``utils/preemption.py``).

The reference asks SLURM for a preemption warning (``#SBATCH
--signal=USR1@120``, ``tml_project.slurm:7``) and never handles it.  Here
SIGTERM and SIGUSR1 set a flag that the PGD loop polls between iterations;
``api.immunize`` then saves the attack state, so that a relaunch resumes
with ``immunize(..., resume_from=...)``.
"""

from __future__ import annotations

import contextlib
import signal
import threading
from typing import Iterator


class PreemptionFlag:
    def __init__(self):
        self._event = threading.Event()
        self.signum = None

    def set(self, signum=None):
        self.signum = signum
        self._event.set()

    def __bool__(self) -> bool:
        return self._event.is_set()


@contextlib.contextmanager
def preemption_guard(signals=(signal.SIGTERM, signal.SIGUSR1)) -> Iterator[PreemptionFlag]:
    """Install handlers for ``signals`` that set the yielded flag, and
    restore the previous handlers on exit.  Outside the main thread (where
    the signal module refuses handlers) the flag is never set."""
    flag = PreemptionFlag()
    previous = {}
    try:
        for s in signals:
            previous[s] = signal.signal(s, lambda signum, frame: flag.set(signum))
    except ValueError:  # not the main thread
        pass
    try:
        yield flag
    finally:
        for s, h in previous.items():
            signal.signal(s, h)
