"""Incremental KV-pool checkpoints riding a background command stream
(port of ``repro/checkpoint/pool_checkpoint.py``).

RowClone §3.1 frames process checkpointing as a bulk-copy workload: the
bytes to persist are copied inside memory first, so the running process
never stops for host I/O.  :class:`PoolCheckpoint` does that for the
serving engine's KV pools:

* each :meth:`step` copies the next **window** of primary-pool blocks into
  the ``spill`` pools (``PoolSpec(role="spill")``) as ``OP_CROSS_POOL_COPY``
  rows on a dedicated ``"ckpt"`` :class:`~repro_torch.core.stream
  .CommandStream`: one fused drain (K1) per window;
* the window copied at step *N* is harvested to a host mirror at step
  *N+1*: the ticket's wait is scoped to the spill pools, and each spill
  pool's window comes to the host in one copy;
* when the cursor completes a pass over the pools, the mirror persists
  through the :class:`~repro_torch.checkpoint.manager.CheckpointManager`
  as one restorable :class:`~repro_torch.core.journal.PoolSnapshot`
  (bfloat16 pools as their uint16 bits).

A pass assembled while decode keeps writing the pools is a *fuzzy*
snapshot: serving recovery uses it only to restore DEAD pools and
reproduces live sequences by eviction and re-admission; the bitwise
snapshot + replay contract holds for a pass that ran quiesced
(:meth:`drain`).  The snapshot's ``index`` is the ckpt flush index of the
pass's last window.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.core.journal import PoolSnapshot, host_dtype, to_host
from repro_torch.core.poolspec import BlockRef


class PoolCheckpoint:
    """Windowed, stream-backed checkpointing of an engine's primary pools.

    ``engine`` must carry at least one ``spill``-role pool (its ``paired``
    primary is what gets checkpointed).  ``window`` bounds the blocks
    copied per step (default: the spill pools' capacity).  Drive it with
    one :meth:`step` per decode round; :meth:`latest` at recovery time and
    :meth:`reset` after a recovery."""

    def __init__(self, engine, manager: CheckpointManager,
                 window: Optional[int] = None):
        spill = {spec.paired: spec.name for spec in engine.group
                 if spec.role == "spill"}
        if not spill:
            raise ValueError(
                "PoolCheckpoint needs spill pools (PoolSpec(role='spill') "
                "paired with the primaries to checkpoint); serving builds "
                "them with make_serving_pools(ckpt_nblk=...)")
        self.engine = engine
        self.manager = manager
        self.spill: Dict[str, str] = spill   # primary name -> spill name
        self.nblk = engine.num_blocks
        cap = min(engine.group[s].nblk for s in spill.values())
        self.window = min(int(window), cap) if window else cap
        #: the checkpoint stream: its flushes are ordinary engine drains
        #: (journaled, hazard-tracked, fused)
        self.stream = engine.stream("ckpt")
        self._cursor = 0
        self._passes = 0          # completed full passes (= save steps)
        self._inflight = None     # (ticket, start, count)
        self._pass_index = -1     # last harvested ckpt flush index
        self._mirror: Dict[str, np.ndarray] = {}
        for name in spill:
            shape, dtype = engine._pool_layouts[name]
            self._mirror[name] = np.zeros(shape, host_dtype(dtype))

    # ------------------------------------------------------------------
    @property
    def passes(self) -> int:
        """Completed full passes over the pools (one save each)."""
        return self._passes

    def _harvest(self) -> None:
        """Pull the previous window's spill bytes into the host mirror."""
        if self._inflight is None:
            return
        ticket, start, w = self._inflight
        self._inflight = None
        try:
            # scoped to the spill pools: a decode step that wrote the
            # primaries since does not stop the harvest
            ticket.wait()
        except RuntimeError:
            # a touched pool was killed since; the copy below reads the
            # pool the engine holds now
            pass
        ba = self.engine.block_axis
        for pname, sname in self.spill.items():
            got = to_host(self.engine.pools[sname].narrow(ba, 0, w))
            if ba == 0:
                self._mirror[pname][start:start + w] = got
            else:
                self._mirror[pname][:, start:start + w] = got
        self._pass_index = ticket.index

    def _save_pass(self) -> None:
        self.manager.save(self._passes, {
            "index": np.asarray(self._pass_index, np.int64),
            "pools": self._mirror})
        self._passes += 1
        self._cursor = 0

    def step(self) -> Optional[object]:
        """One checkpoint tick: harvest the in-flight window, persist the
        pass if it just completed, enqueue and flush the next window on
        the ckpt stream.  Returns the window's
        :class:`~repro_torch.core.stream.FlushTicket` (None when there
        is nothing to copy)."""
        self._harvest()
        if self._cursor >= self.nblk:
            self._save_pass()
        start = self._cursor
        w = min(self.window, self.nblk - start)
        if w <= 0:
            return None
        pairs = [(BlockRef(pname, start + j), BlockRef(sname, j))
                 for pname, sname in self.spill.items()
                 for j in range(w)]
        self.stream.memcopy_cross(pairs)
        ticket = self.stream.flush()
        self._inflight = (ticket, start, w)
        self._cursor = start + w
        return ticket

    def drain(self) -> None:
        """Finish the current pass synchronously (copy the remaining
        windows, harvest, persist): the quiesced, exact-snapshot path."""
        while self._cursor < self.nblk:
            self.step()
        self._harvest()
        self._save_pass()
        self.manager.wait()

    # ------------------------------------------------------------------
    def latest(self) -> Optional[PoolSnapshot]:
        """The most recent persisted pass as a :class:`PoolSnapshot`
        (None before the first pass).  Covers the checkpointed primaries
        only: recovery resurrects staging and spill pools as zeros."""
        self.manager.wait()
        step = self.manager.latest_step()
        if step is None:
            return None
        example = {"index": 0, "pools": {name: 0 for name in self.spill}}
        tree, _ = self.manager.restore(example, step)
        return PoolSnapshot(index=int(tree["index"]),
                            arrays=dict(tree["pools"]))

    def reset(self) -> None:
        """Drop the in-flight window after a recovery (the spill pools
        may have been resurrected; the interrupted pass restarts from
        block 0).  Persisted passes are untouched."""
        self._inflight = None
        self._cursor = 0


__all__ = ["PoolCheckpoint"]
