"""Tuned engine constants: a persisted per-backend ``TunedProfile`` (port
of ``repro/obs/autotune.py``).

The engine's throughput constants (the bucket set of ``cmdqueue``, the
``overlap`` toggle, the staging-ring capacity and the sharded bound
``max_delta_signatures``) were hand-picked.  The port reads and writes all
four, but only the bucket set and the ring capacity apply: K1 has no
overlapped-DMA toggle, and the sharded drain compiles nothing per plan, so
there is no cache for ``max_delta_signatures`` to bound.
``launch/autotune.py`` sweeps them against representative command
streams, picks winners with :func:`pick_winner` and persists the result
as a JSON :class:`TunedProfile` under ``configs/tuned/<backend>.json``.
The schema and the JSON are the reference's, so a file either package
wrote loads in the other.

``RowCloneEngine`` / ``ServingEngine`` call :func:`load_profile` at
startup; precedence is **explicit kwarg > tuned profile > built-in
default**.  A missing file (or ``REPRO_NO_TUNED=1``) means the built-in
defaults.  The backend key is ``"cuda"`` for pools on the card and
``"cpu"`` otherwise (:func:`backend_key`), so on the CPU both packages
resolve the same knobs from the same ``configs/tuned/cpu.json``.
:func:`pick_winner` keeps the default unless a candidate beats it by a
clear margin (3%), so a profile never encodes a noise-level "win".

Stdlib only at import; :func:`apply_profile` imports the core lazily.
"""
from __future__ import annotations

import dataclasses
import json
import os
import pathlib
from typing import Dict, Optional, Sequence, Tuple

#: profile JSON schema version (bump on incompatible field changes)
PROFILE_SCHEMA = 1

#: required margin (fractional) before a candidate unseats the default
DEFAULT_MARGIN = 0.03

_LOGGED: set = set()


@dataclasses.dataclass(frozen=True)
class TunedProfile:
    """One backend's tuned engine constants and the measurements behind
    them.  ``ring_capacity=None`` keeps the serving layer's
    policy-derived staging ring.  ``max_delta_signatures`` is read and
    written for the reference's schema; it bounds the reference's jit
    cache, and the port's sharded drain has none, so it applies to
    nothing."""

    backend: str                              #: "cpu" or "cuda"
    buckets: Tuple[int, ...] = (8, 32, 128, 512)   #: table bucket sizes
    overlap: bool = True                      #: the reference's DMA toggle (no K1 counterpart)
    max_delta_signatures: int = 8             #: sharded jit-cache fold bound
    ring_capacity: Optional[int] = None       #: staging ring slots (None = policy)
    us_per_flush: float = 0.0                 #: winner's measured median
    baseline_us_per_flush: float = 0.0        #: defaults' measured median
    swept: Dict = dataclasses.field(default_factory=dict)  #: sweep summary
    schema: int = PROFILE_SCHEMA              #: profile format version

    def to_dict(self) -> Dict:
        """JSON-ready dict (tuples become lists)."""
        d = dataclasses.asdict(self)
        d["buckets"] = list(self.buckets)
        return d

    @classmethod
    def from_dict(cls, d: Dict) -> "TunedProfile":
        """Rebuild from :meth:`to_dict` output (unknown keys are ignored,
        so newer files load under older code)."""
        names = {f.name for f in dataclasses.fields(cls)}
        kw = {k: v for k, v in d.items() if k in names}
        kw["buckets"] = tuple(int(b) for b in kw.get("buckets",
                                                     (8, 32, 128, 512)))
        if kw.get("ring_capacity") is not None:
            kw["ring_capacity"] = int(kw["ring_capacity"])
        return cls(**kw)


def tuned_dir() -> pathlib.Path:
    """Directory of the per-backend profile JSONs: ``$REPRO_TUNED_DIR``
    when set, else ``configs/tuned/`` at the repo root."""
    env = os.environ.get("REPRO_TUNED_DIR")
    if env:
        return pathlib.Path(env)
    return pathlib.Path(__file__).resolve().parents[3] / "configs" / "tuned"


def backend_key(device=None) -> str:
    """The profile key: ``"cuda"`` for a CUDA device (``device=None``:
    when a card is visible), ``"cpu"`` otherwise."""
    if device is None:
        import torch
        return "cuda" if torch.cuda.is_available() else "cpu"
    kind = getattr(device, "type", str(device).split(":")[0])
    return "cuda" if kind == "cuda" else "cpu"


def profile_path(backend: Optional[str] = None,
                 directory: Optional[pathlib.Path] = None) -> pathlib.Path:
    """Path of ``backend``'s profile file (default: :func:`backend_key`
    under :func:`tuned_dir`)."""
    backend = backend or backend_key()
    directory = pathlib.Path(directory) if directory else tuned_dir()
    return directory / f"{backend}.json"


def save_profile(profile: TunedProfile,
                 directory: Optional[pathlib.Path] = None) -> pathlib.Path:
    """Persist ``profile`` as ``<dir>/<backend>.json`` (dir created);
    returns the written path."""
    path = profile_path(profile.backend, directory)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(profile.to_dict(), indent=2,
                               sort_keys=True) + "\n")
    return path


def load_profile(backend: Optional[str] = None,
                 directory: Optional[pathlib.Path] = None
                 ) -> Optional[TunedProfile]:
    """The backend's :class:`TunedProfile`, or None when no file exists
    (or ``REPRO_NO_TUNED=1``).  A malformed file gives None.  Logs one
    startup line per (backend, path) the first time a profile loads in a
    process."""
    if os.environ.get("REPRO_NO_TUNED"):
        return None
    path = profile_path(backend, directory)
    if not path.is_file():
        return None
    try:
        prof = TunedProfile.from_dict(json.loads(path.read_text()))
    except (ValueError, TypeError, KeyError):
        return None       # malformed file degrades to defaults
    tag = (prof.backend, str(path))
    if tag not in _LOGGED:
        _LOGGED.add(tag)
        print(f"[obs] tuned profile loaded: backend={prof.backend} "
              f"buckets={list(prof.buckets)} overlap={prof.overlap} "
              f"max_delta_signatures={prof.max_delta_signatures} "
              f"ring_capacity={prof.ring_capacity} ({path})")
    return prof


def apply_profile(profile: TunedProfile) -> Dict[str, object]:
    """Install the profile's PROCESS-WIDE knobs: the ``cmdqueue`` bucket
    set (the per-engine ``ring_capacity`` resolves in ServingEngine's
    constructor, where an explicit kwarg wins; ``overlap`` applies to
    nothing, K1 has no overlapped-DMA toggle).  Returns the
    applied values; ``max_delta_signatures`` is returned as read, since
    the port's sharded drain has no jit cache to bound."""
    from repro_torch.core import cmdqueue
    cmdqueue.set_buckets(profile.buckets)
    return {"buckets": tuple(profile.buckets),
            "max_delta_signatures": profile.max_delta_signatures}


def pick_winner(rows: Sequence[Dict], default_cfg: Dict,
                margin: float = DEFAULT_MARGIN) -> Dict:
    """The sweep's winning row.

    ``rows`` are ``{"cfg": {...}, "us_per_flush": float}``; ``default_cfg``
    names the hand-picked configuration.  The fastest candidate wins ONLY
    if it beats the default's ``us_per_flush`` by more than ``margin``;
    otherwise the default's row is returned."""
    if not rows:
        raise ValueError("pick_winner needs at least one sweep row")
    default_rows = [r for r in rows if r["cfg"] == default_cfg]
    if not default_rows:
        raise ValueError("sweep must include the default configuration")
    default_row = min(default_rows, key=lambda r: r["us_per_flush"])
    best = min(rows, key=lambda r: r["us_per_flush"])
    if best["us_per_flush"] < default_row["us_per_flush"] * (1.0 - margin):
        return best
    return default_row


__all__ = ["TunedProfile", "PROFILE_SCHEMA", "DEFAULT_MARGIN", "tuned_dir",
           "backend_key", "profile_path", "save_profile", "load_profile",
           "apply_profile", "pick_winner"]
