"""Fault tolerance: failure injection, heartbeat ledger, restart loop
(port of ``repro/runtime/fault.py``, single device).

**Serving-side failure injection**: :class:`FaultPlan` plugs into the
engine's per-chunk drain guards (``kernels/fused_dispatch.py``
``add_drain_guard``) and raises :class:`InjectedFault` on the host at
chosen engine flush indices:

* *launch failures* fire before a flush's FIRST chunk dispatches (the
  whole flush aborts; nothing moved);
* *mid-flush aborts* fire before a LATER chunk (the dispatched prefix is
  journaled as an aborted record and the suffix stashed, the partial-flush
  case ``RowCloneEngine.recover`` re-drains);
* *donation errors* stand for a staging buffer dying mid-admission:
  :meth:`FaultPlan.check_admission` kills the staging pools
  (``RowCloneEngine.kill_pool`` frees their storage) and raises.

A plan binds to ONE engine (``install(engine)``): the guard ignores other
engines' drains, so a clean twin runs beside the faulted engine.  Each
injection fires at most once.

The restart loop (:func:`run_with_restarts`) and the
:class:`HeartbeatLedger` are the training side's; the port has no mesh, so
``run_with_restarts`` restores without placement.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Iterator, List, Optional, Set, Tuple

import numpy as np

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.kernels.fused_dispatch import (DrainInfo, add_drain_guard,
                                                remove_drain_guard)
from repro_torch.obs import metrics as obs_metrics


class NodeFailure(RuntimeError):
    """Raised (or injected in tests) when a node is lost mid-step."""


class InjectedFault(RuntimeError):
    """A :class:`FaultPlan` injection fired: the deliberate failure the
    recovery path is exercised against."""


@dataclasses.dataclass
class FaultPlan:
    """Deterministic failure injections against ONE engine's drain path.

    ``launch_failures`` / ``midflush_aborts`` name engine flush indices
    (``engine.next_flush_index`` before the targeted flush): a launch
    failure raises before chunk 0 dispatches, a mid-flush abort before the
    SECOND chunk (a flush of one chunk, under 512 spaced rows, never sees
    it).  ``donation_errors`` name admission ordinals checked by
    :meth:`check_admission`.  Every injection fires at most once;
    ``fired`` records what triggered::

        plan = FaultPlan(launch_failures=(eng.next_flush_index,))
        with plan.active(eng):
            ...   # the targeted flush raises InjectedFault
        eng.recover()
    """

    launch_failures: Tuple[int, ...] = ()
    midflush_aborts: Tuple[int, ...] = ()
    donation_errors: Tuple[int, ...] = ()

    def __post_init__(self):
        self.fired: List[Tuple[str, int]] = []
        self._engine: Optional[object] = None
        self._seen: Set[Tuple[str, int]] = set()

    def install(self, engine) -> "FaultPlan":
        """Bind to ``engine`` and hook its drain path."""
        if self._engine is not None:
            raise RuntimeError("FaultPlan already installed")
        self._engine = engine
        add_drain_guard(self._guard)
        return self

    def remove(self) -> None:
        """Unhook from the drain path (idempotent)."""
        if self._engine is None:
            return
        self._engine = None
        remove_drain_guard(self._guard)

    @contextlib.contextmanager
    def active(self, engine) -> Iterator["FaultPlan"]:
        """``install`` on entry, ``remove`` on exit."""
        self.install(engine)
        try:
            yield self
        finally:
            self.remove()

    def _fire(self, kind: str, index: int) -> None:
        key = (kind, index)
        if key in self._seen:
            return
        self._seen.add(key)
        self.fired.append(key)
        raise InjectedFault(f"injected {kind} at flush {index}")

    def _guard(self, info: DrainInfo) -> None:
        if info.engine is not self._engine:
            return
        if info.chunk == 0 and info.flush in self.launch_failures:
            self._fire("launch_failure", info.flush)
        if info.chunk >= 1 and info.flush in self.midflush_aborts:
            self._fire("midflush_abort", info.flush)

    def check_admission(self, ordinal: int, engine) -> None:
        """Admission-path hook: when ``ordinal`` is scheduled for a
        donation error, kill the engine's staging pools and raise
        :class:`InjectedFault`.  The serving layer must then resurrect the
        staging ring and evict the admission."""
        if ordinal not in self.donation_errors or \
                engine is not self._engine:
            return
        key = ("donation_error", ordinal)
        if key in self._seen:
            return
        self._seen.add(key)
        self.fired.append(key)
        for name in engine.staging:
            engine.kill_pool(name)
        raise InjectedFault(f"injected donation_error at admission "
                            f"{ordinal}")


@dataclasses.dataclass
class StragglerReport:
    step: int
    step_time: float
    median: float
    ratio: float


class HeartbeatLedger:
    """Rolling per-step wall-time record with straggler detection."""

    def __init__(self, window: int = 50, threshold: float = 2.0):
        self.window = window
        self.threshold = threshold
        self.times: List[float] = []
        self.reports: List[StragglerReport] = []
        self._t0: Optional[float] = None

    def step_start(self) -> None:
        self._t0 = obs_metrics.now()

    def step_end(self, step: int) -> Optional[StragglerReport]:
        """Record the step's wall time; a report when it exceeds
        ``threshold`` x the window's median (after 5 steps).  A
        ``step_end`` without its ``step_start`` records nothing."""
        if self._t0 is None:
            return None
        dt = obs_metrics.now() - self._t0
        self._t0 = None
        self.times.append(dt)
        hist = self.times[-self.window:]
        med = float(np.median(hist))
        if len(hist) >= 5 and dt > self.threshold * med:
            rep = StragglerReport(step, dt, med, dt / med)
            self.reports.append(rep)
            return rep
        return None


@dataclasses.dataclass
class RestartPolicy:
    max_restarts: int = 3
    checkpoint_every: int = 50


def run_with_restarts(train_loop: Callable[[int, object], object],
                      init_state, ckpt: CheckpointManager,
                      policy: RestartPolicy, shardings=None) -> object:
    """Drive ``train_loop(start_step, state) -> state`` with restart on
    :class:`NodeFailure`: resume from the latest checkpoint (or from the
    start), at most ``policy.max_restarts`` times.  ``shardings`` (a tree
    of ``launch.mesh.Sharding`` matching the state) places the restored
    state (``CheckpointManager.restore``)."""
    state = init_state
    start = 0
    restarts = 0
    while True:
        try:
            return train_loop(start, state)
        except NodeFailure as e:
            restarts += 1
            if restarts > policy.max_restarts:
                raise RuntimeError(
                    f"exceeded {policy.max_restarts} restarts") from e
            step = ckpt.latest_step()
            if step is None:
                state, start = init_state, 0
            else:
                state, start = ckpt.restore(init_state, step,
                                            shardings=shardings)
                start = step
