"""Logical-axis sharding rules (port of ``repro/sharding/rules.py``).

Model code names array dimensions by *logical* axes; this module resolves
them against a :class:`~repro_torch.launch.mesh.DeviceMesh`, dropping mesh
axes the mesh does not have, so the same rules serve a single-pod mesh, a
multi-pod one and a mesh of one rank.  :data:`DEFAULT_RULES` are the
serving rules (sequence-parallel ``act_seq_tp`` over ``model``, which
sends the moe FFN down its all-to-all path); :data:`FSDP_RULES` are the
training rules (the batch over every axis), activated with
:class:`use_rules`.  The moe dispatch reads the active set through
:func:`active_rules`.

:func:`logical_to_spec` returns the reference's ``PartitionSpec`` as a
plain tuple: one entry per dimension, ``None``, a mesh axis name, or a
tuple of axis names sharded jointly.  ``launch/mesh.py`` ``sharding_for``
reads it to place the training state, every serving family's weights
(``weights.place_params``) and a placed model's serve state; ``models/attention.py attention_train`` to
split the training attention into the blocks the reference's
``constrain`` names, and the placed model's blocks (``models/lm.py``,
``models/attention.py placed_qkv_shardings``, ``models/mamba2.py
ssm_layouts``) to lay out its residual, q, k and a Mamba2 layer's heads
and channels as the reference's ``constrain`` points do;
``models/transformer.py`` asks :func:`attn_strategy` which of its two
attention layouts to use.  The reference's ``constrain`` and
``named_sharding`` have no counterpart: they hand a placement to GSPMD,
and the port places every tensor explicitly, so there is nothing to
annotate.  What is placed: the training state, a training step's bf16
views, batch and every activation of its loss and backward (by blocks on
their ranks); the pools' slabs; every serving family's weights
(``weights.place_params``) and its activations by blocks on their ranks,
with a facade's recurrent and cross state (``models/lm.py
STATE_AXES``); a moe FFN's mesh paths.  Everything else (an unplaced
model's serving weights and activations) lies whole on the model's
device.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.launch.mesh import DeviceMesh

# logical axis -> preferred mesh axes (the first entry present in the mesh
# is used; a tuple shards over all of its axes jointly)
DEFAULT_RULES: Dict[str, Sequence] = {
    # activations
    "batch": (("pod", "data"),),
    "act_seq": (None,),
    "act_seq_tp": ("model",),
    "act_heads": ("model",),
    "act_kv_heads": ("model",),
    "act_embed": (None,),
    "act_ffn": ("model",),
    "act_experts": ("model",),
    "act_vocab": ("model",),
    # parameters (ZeRO-3: the non-TP dim shards over data)
    "embed": ("data",),
    "vocab": ("model",),
    "qkv": ("model",),
    "heads": ("model",),
    "ffn": ("model",),
    "experts": ("model",),
    "ssm_inner": ("model",),
    "ssm_heads_p": ("model",),
    "layers": (None,),
    "norm": ("data",),
    "conv_w": (None,),
    "conv_ch": ("model",),
    "ssm_state_p": (None,),
    # paged pools: the block axis over every mesh axis (the slabs)
    "kv_blocks": (("pod", "data", "model"),),
    "kv_seq": ("model",),
    "replicated": (None,),
}

# training rules: the batch over every mesh axis, parameters ZeRO-sharded
# over all axes on their d_model-like dim; ordered fallbacks let each dim
# take the largest axis group that divides it
FSDP_RULES: Dict[str, Sequence] = {
    "batch": (("pod", "data", "model"), ("data", "model"), ("pod", "data"),
              ("data",)),
    "act_seq": (None,),
    "act_seq_tp": (None,),
    "act_heads": (None,),
    "act_kv_heads": (None,),
    "act_embed": (None,),
    "act_ffn": (None,),
    "act_experts": (None,),
    "act_vocab": (None,),
    "embed": (("pod", "data", "model"), ("data", "model"), ("data",)),
    "vocab": (None,),
    "qkv": (None,),
    "heads": (None,),
    "ffn": (None,),
    "experts": (None,),
    "ssm_inner": (("pod", "data", "model"), ("data", "model"), ("data",)),
    "ssm_heads_p": (None,),
    "layers": (None,),
    "norm": (("pod", "data", "model"), ("data", "model"), ("data",)),
    "conv_w": (None,),
    "conv_ch": (None,),
    "ssm_state_p": (None,),
    "kv_blocks": (("pod", "data", "model"),),
    "kv_seq": ("model",),
    "replicated": (None,),
}

_ACTIVE_RULES: List[Dict] = []

#: one entry of a resolved spec: no sharding, one mesh axis, or axes
#: sharded jointly
SpecEntry = Optional[object]


class use_rules:
    """Context manager activating another rule set (``FSDP_RULES`` while a
    training step runs); nests."""

    def __init__(self, rules: Dict):
        self.rules = rules

    def __enter__(self):
        _ACTIVE_RULES.append(self.rules)
        return self.rules

    def __exit__(self, *exc):
        _ACTIVE_RULES.pop()


def active_rules() -> Dict:
    """The innermost :class:`use_rules` set, else :data:`DEFAULT_RULES`."""
    return _ACTIVE_RULES[-1] if _ACTIVE_RULES else DEFAULT_RULES


def mesh_axis_names(mesh: DeviceMesh) -> Tuple[str, ...]:
    return tuple(mesh.axis_names)


def _resolve_entry(entry, axis_names, dim: Optional[int], mesh: DeviceMesh,
                   used) -> SpecEntry:
    """One rule entry against the mesh's axes not yet used (and, when the
    dim is known, its divisibility): a tuple entry resolves to the subset
    of its axes present, one axis to its name."""
    if entry is None:
        return None
    flat = entry if isinstance(entry, tuple) else (entry,)
    present = tuple(a for a in flat if a in axis_names and a not in used)
    if not present:
        return None
    if dim is not None:
        if dim % math.prod(mesh.axis_size(a) for a in present):
            return None
    return present if len(present) > 1 else present[0]


def logical_to_spec(logical_axes: Sequence[Optional[str]], mesh: DeviceMesh,
                    rules: Optional[Dict] = None,
                    dims: Optional[Sequence[Optional[int]]] = None
                    ) -> Tuple[SpecEntry, ...]:
    """Map logical axis names (or None) to the reference's
    ``PartitionSpec`` entries, as a tuple.  ``dims`` (parallel to
    ``logical_axes``): the dimension sizes; a rule's fallbacks are tried
    in order until one divides its dim.  A mesh axis shards at most one
    dimension."""
    rules = rules or active_rules()
    axis_names = mesh_axis_names(mesh)
    out, used = [], set()
    for i, name in enumerate(logical_axes):
        if name is None:
            out.append(None)
            continue
        dim = dims[i] if dims is not None else None
        resolved = None
        for cand in rules.get(name, (None,)):
            resolved = _resolve_entry(cand, axis_names, dim, mesh, used)
            if resolved is not None:
                break
        if resolved is not None:
            used.update(resolved if isinstance(resolved, tuple)
                        else (resolved,))
        out.append(resolved)
    return tuple(out)


def axis_size(mesh: DeviceMesh, axis) -> int:
    """Ranks along ``axis`` (a name or a tuple of names, jointly; each
    name through ``DeviceMesh.axis_size``); 1 for an axis the mesh does
    not have."""
    if isinstance(axis, tuple):
        return math.prod(axis_size(mesh, a) for a in axis)
    return mesh.axis_size(axis) if axis in mesh.axis_names else 1


def attn_strategy(num_q_heads: int, mesh: DeviceMesh) -> str:
    """``"heads"`` when the query heads shard over ``model``, else
    ``"seq"``."""
    tp = axis_size(mesh, "model")
    return "heads" if num_q_heads % tp == 0 else "seq"


__all__ = ["DEFAULT_RULES", "FSDP_RULES", "active_rules", "attn_strategy",
           "axis_size", "logical_to_spec", "mesh_axis_names", "use_rules"]
