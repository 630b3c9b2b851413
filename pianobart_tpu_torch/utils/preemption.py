"""Graceful preemption for long training runs
(``pianobart_tpu/utils/preemption.py``).

Accelerator jobs get preempted: spot reclaim, maintenance, a scheduler's
SIGTERM.  The reference loses everything since its last epoch-end
``torch.save`` (``main.py:65-100``).  Here:

* :class:`PreemptionGuard` turns the first SIGTERM/SIGINT into a flag;
* the runner (``train/runner.py``) polls it at dispatch boundaries and at the
  top of each epoch, writes the mid-epoch ``safety`` checkpoint
  (``train/state.py:CheckpointManager.save_safety``) and raises
  :class:`Preempted`;
* the CLI exits with :data:`EXIT_PREEMPTED` (75, ``EX_TEMPFAIL``, "transient,
  requeue me"); rerunning with ``--resume`` restarts the interrupted epoch
  from the safety slot.

A second signal while the graceful save is in flight restores the previous
handlers and raises ``KeyboardInterrupt``: the way out when the save hangs.
"""
from __future__ import annotations

import signal
import sys
from typing import Optional

__all__ = ["EXIT_PREEMPTED", "Preempted", "PreemptionGuard"]

# os.EX_TEMPFAIL: what requeue-on-preempt schedulers look for
EXIT_PREEMPTED = 75


class Preempted(RuntimeError):
    """Raised by a runner after the graceful safety checkpoint is written."""


class PreemptionGuard:
    """First SIGTERM/SIGINT sets :attr:`requested`; the second re-raises.

    Install from the main thread only (CPython restricts ``signal.signal``);
    elsewhere :meth:`install` returns ``None`` and the caller runs without
    preemption handling.
    """

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self) -> None:
        self.requested = False
        self._prev: dict = {}

    def install(self) -> Optional["PreemptionGuard"]:
        try:
            for s in self.SIGNALS:
                self._prev[s] = signal.signal(s, self._handle)
        except ValueError:  # not the main thread
            self._prev.clear()
            return None
        return self

    def uninstall(self) -> None:
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev.clear()

    def _handle(self, signum, frame):
        if self.requested:
            # second signal: out now
            self.uninstall()
            raise KeyboardInterrupt
        self.requested = True
        name = signal.Signals(signum).name
        print(f"[preempt] caught {name}: finishing the in-flight step, "
              f"saving a safety checkpoint, then exiting {EXIT_PREEMPTED}; "
              f"signal again to abort immediately", file=sys.stderr)
