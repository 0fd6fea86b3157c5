"""Async, versioned, atomic checkpointing (port of
``repro/checkpoint/manager.py``, with the same on-disk layout).

Durability protocol: write ``step_N.tmp/`` then ``os.replace`` it to
``step_N/`` (atomic on POSIX).  ``arrays.npz`` holds the state's leaves as
``a0, a1, ...`` in the JAX package's flatten order (nested dicts by sorted
key, then lists and tuples in order, ``None`` holding no leaf), and
``manifest.json`` their keys, shapes and dtypes; ``latest`` is resolved by
scanning complete directories, so a crash mid-write never yields a half
checkpoint.  A checkpoint either package writes is one the other restores.

The port's pools and parameters are mutated IN PLACE, so the reference's
zero-copy snapshot (an immutable array handle) does not carry over:
:meth:`CheckpointManager.save` copies every tensor to the host on the
calling thread (bfloat16 as its uint16 bits, ``core/journal.py
to_host``), and only the disk write runs on the background thread.

A state placed over a rank mesh (``launch.mesh.Sharded`` leaves) is saved
as whole arrays, as the reference's ``np.asarray`` saves a sharded
``jax.Array``, so a checkpoint does not depend on the mesh it came from;
:meth:`CheckpointManager.restore` places each leaf by the ``Sharding``
it is given (an elastic restore passes the new mesh's).

Each save, write and restore records its microseconds on the port's clock
in the histograms ``ckpt.save_us`` (the host copy on the calling thread),
``ckpt.write_us`` (the disk write, on the background thread when async)
and ``ckpt.restore_us`` (``obs/metrics.py``).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.journal import from_host, to_host
from repro_torch.launch.mesh import Sharded, Sharding, gather, place
from repro_torch.obs import metrics as obs_metrics


def _leaves(tree) -> List[Any]:
    """The leaves of a nested dict / list / tuple, in JAX's flatten order
    (dict keys sorted; ``None`` is an empty subtree)."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _rebuild(example, leaves) -> Any:
    """``example``'s structure with its leaves taken, in order, from the
    iterator ``leaves``."""
    if example is None:
        return None
    if isinstance(example, dict):
        out = {k: _rebuild(example[k], leaves) for k in sorted(example)}
        return {k: out[k] for k in example}
    if isinstance(example, (list, tuple)):
        items = [_rebuild(v, leaves) for v in example]
        if hasattr(example, "_fields"):          # a NamedTuple
            return type(example)(*items)
        return type(example)(items)
    return next(leaves)


def _host_copy(leaf) -> np.ndarray:
    """A host copy of one leaf, made now (the caller may mutate it); a
    sharded leaf whole."""
    if isinstance(leaf, Sharded):
        return to_host(gather(leaf, "cpu"))
    if isinstance(leaf, torch.Tensor):
        return to_host(leaf)
    return np.array(leaf, copy=True)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep = keep
        self.async_save = async_save
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------
    def save(self, step: int, state, blocking: bool = False) -> None:
        """Checkpoint ``state`` (a nested dict / list / tuple / NamedTuple
        of tensors and numpy arrays, e.g. ``launch/train.py TrainState``)
        at ``step``.  Every leaf is copied to the host
        before this returns; the disk write runs on a background thread
        unless ``async_save`` is off or ``blocking`` is set."""
        self.wait()  # one in-flight save at a time
        t0 = obs_metrics.now()
        flat = {f"a{i}": _host_copy(v) for i, v in enumerate(_leaves(state))}
        obs_metrics.observe("ckpt.save_us", (obs_metrics.now() - t0) * 1e6)
        if self.async_save and not blocking:
            self._thread = threading.Thread(target=self._write,
                                            args=(step, flat), daemon=True)
            self._thread.start()
        else:
            self._write(step, flat)

    def _write(self, step: int, flat: Dict[str, np.ndarray]) -> None:
        t0 = obs_metrics.now()
        try:
            tmp = os.path.join(self.dir, f"step_{step}.tmp")
            final = os.path.join(self.dir, f"step_{step}")
            if os.path.exists(tmp):
                shutil.rmtree(tmp)
            os.makedirs(tmp)
            np.savez(os.path.join(tmp, "arrays.npz"), **flat)
            manifest = {
                "step": step,
                "time": time.time(),  # rowlint: disable=RC105 (manifest time-of-day stamp)
                "keys": sorted(flat),
                "shapes": {k: list(v.shape) for k, v in flat.items()},
                "dtypes": {k: str(v.dtype) for k, v in flat.items()},
            }
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)
            self._gc()
            obs_metrics.observe("ckpt.write_us",
                                (obs_metrics.now() - t0) * 1e6)
        except BaseException as e:  # surfaced on next wait()
            self._error = e

    def wait(self) -> None:
        """Join the in-flight save; re-raise its error, if any."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # ------------------------------------------------------------------
    def steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                path = os.path.join(self.dir, name, "manifest.json")
                if os.path.exists(path):
                    out.append(int(name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    def restore(self, example_state, step: Optional[int] = None,
                shardings=None):
        """Rebuild ``example_state``'s structure from checkpoint ``step``
        (default: the latest).  A tensor leaf of the example comes back as
        a tensor of its dtype on its device (bits reinterpreted for
        bfloat16), a ``Sharded`` leaf placed as it is, any other leaf as
        the stored numpy array.  ``shardings``: a tree matching the state
        of ``launch.mesh.Sharding`` leaves; each leaf is then placed by
        its own (``launch.mesh.place``) in the example's dtype.  Returns
        ``(state, step)``."""
        self.wait()
        t0 = obs_metrics.now()
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        path = os.path.join(self.dir, f"step_{step}", "arrays.npz")
        examples = _leaves(example_state)
        placements = _leaves(shardings) if shardings is not None \
            else [getattr(ex, "sharding", None) for ex in examples]
        with np.load(path) as data:
            loaded = []
            for i, (ex, sh) in enumerate(zip(examples, placements)):
                a = data[f"a{i}"]
                if isinstance(sh, Sharding):
                    a = place(from_host(a, ex.dtype, "cpu"), sh)
                elif isinstance(ex, torch.Tensor):
                    a = from_host(a, ex.dtype, ex.device)
                loaded.append(a)
        obs_metrics.observe("ckpt.restore_us", (obs_metrics.now() - t0) * 1e6)
        return _rebuild(example_state, iter(loaded)), step

    def _gc(self) -> None:
        steps = self.steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s}"),
                          ignore_errors=True)


__all__ = ["CheckpointManager"]
