"""Message-driven FEC synchronizer, fec_sync (a copy of
``grbaz_tpu/models/fec_sync.py``, which imports nothing of JAX but sits
in a package whose ``__init__`` does).

Capability parity with python/fec_sync.py — the GR 3.7 message-based
re-implementation of the auto-FEC search (SURVEY.md §2.2): instead of
watching a BER stream (models/auto_fec.py), this controller is driven
by three asynchronous message ports:

* ``clock``  — periodic tick; runs the trial/lock state machine
  (reference ``handle_clock`` → ``run``, python/fec_sync.py:129-131,
  202-235).
* ``pdu``    — a successfully decoded frame arrived; first PDU while
  unlocked ⇒ lock (``handle_pdu``, :155-178).
* ``status`` — overrun/fault reports (accepted, currently advisory —
  the reference deliberately lets the lock time out instead,
  ``handle_status``, :133-141).

Search space mirrors ``fec_sync_xform.next`` (:60-76): puncture delay
(mod depuncturer length) fastest, then 0°/90° rotation, then
conjugation toggle — each trial held for ``trial_duration`` seconds;
once locked, absence of PDUs for ``lock_timeout`` seconds resets the
search (``run``, :222-235).

The transform is applied through a caller-supplied ``apply_fn`` — in
this framework that is a params-update on the running graph
(conjugate flag, rotation multiplier, depuncture delay are runtime
params; see ops/fec.py), so a trial step rebuilds nothing.
``time_fn`` is injectable for deterministic tests.
"""

from __future__ import annotations

import time
from typing import Callable, List, Optional, Tuple

_PHASE_MULTIPLICATION: List[Tuple[str, complex]] = [("0", 1), ("90", 1j)]

CHANGE_PUNCTURE_DELAY = 1
CHANGE_ROTATION = 2
CHANGE_CONJUGATION = 3


class FECSyncXform:
    """Search-space point: (puncture_delay, rotation, conjugation).

    ``next(ref, depunc_length)`` advances odometer-style and reports
    which dimensions changed; returns ``(False, ...)`` when the search
    has cycled back to ``ref`` in every dimension (reference :60-76).
    """

    def __init__(self):
        self.reset()

    def reset(self):
        self.conjugate = True
        self.rotation = 0
        self.puncture_delay = 0

    def copy(self) -> "FECSyncXform":
        clone = FECSyncXform()
        clone.conjugate = self.conjugate
        clone.rotation = self.rotation
        clone.puncture_delay = self.puncture_delay
        return clone

    def get_conjugation(self) -> bool:
        return self.conjugate

    def get_rotation(self) -> complex:
        return _PHASE_MULTIPLICATION[self.rotation][1]

    def get_puncture_delay(self) -> int:
        return self.puncture_delay

    def next(self, ref: "FECSyncXform", depunc_length: int):
        changes = [CHANGE_PUNCTURE_DELAY]
        self.puncture_delay = (self.puncture_delay + 1) % depunc_length
        if self.puncture_delay != ref.puncture_delay:
            return True, changes
        changes.append(CHANGE_ROTATION)
        self.rotation = (self.rotation + 1) % len(_PHASE_MULTIPLICATION)
        if self.rotation != ref.rotation:
            return True, changes
        changes.append(CHANGE_CONJUGATION)
        self.conjugate = not self.conjugate
        if self.conjugate != ref.conjugate:
            return True, changes
        return False, changes


class FECSync:
    """The message-driven controller.

    ``apply_fn(conjugate: bool, rotation: complex, puncture_delay: int,
    changes)`` is invoked on every trial step and on reset (changes is
    None on full application).
    """

    def __init__(self, apply_fn: Callable, depunc_length: int,
                 trial_duration: float = 1.0, lock_timeout: float = 5.0,
                 verbose: bool = False,
                 time_fn: Callable[[], float] = time.monotonic):
        self._apply = apply_fn
        self.depunc_length = int(depunc_length)
        self.trial_duration = float(trial_duration)
        self.lock_timeout = float(lock_timeout)
        self.verbose = verbose
        self._now = time_fn

        self.locked = False
        self.xform_lock = FECSyncXform()
        self.xform_search = FECSyncXform()
        self.search_iterations = 0
        self.last_pdu_time: Optional[float] = None
        self.last_xform_time: Optional[float] = None
        self.pdu_count = 0
        self.status_count = 0
        self.set_unlocked()

    # -- message handlers ------------------------------------------------
    def handle_clock(self, msg=None):
        self._run()

    def handle_pdu(self, msg=None):
        self.pdu_count += 1
        self.last_pdu_time = self._now()
        if not self.locked:
            self.set_locked()

    def handle_status(self, msg=None):
        # advisory only — the reference lets the lock time out rather
        # than resetting on an overrun report (:133-141)
        self.status_count += 1

    # -- state machine -----------------------------------------------------
    def set_unlocked(self):
        self.locked = False
        self.xform_lock.reset()
        self.xform_search.reset()
        self.search_iterations = 0
        self._update_xform(self.xform_search)

    def set_locked(self):
        self.locked = True
        self.xform_lock = self.xform_search.copy()

    def _update_xform(self, xform: FECSyncXform, changes=None,
                      time_now: Optional[float] = None):
        self.search_iterations += 1
        self._apply(xform.get_conjugation(), xform.get_rotation(),
                    xform.get_puncture_delay(), changes)
        self.last_xform_time = self._now() if time_now is None else time_now

    def _run(self):
        now = self._now()
        if self.locked:
            if (self.last_pdu_time is not None
                    and now - self.last_pdu_time > self.lock_timeout):
                if self.verbose:
                    print("[FEC] lock timed out")
                self.set_unlocked()
        if not self.locked:
            if (self.last_xform_time is None
                    or now - self.last_xform_time > self.trial_duration):
                more, changes = self.xform_search.next(self.xform_lock,
                                                       self.depunc_length)
                if not more and self.verbose:
                    print("[FEC] cycling search")
                self._update_xform(self.xform_search, changes, now)
