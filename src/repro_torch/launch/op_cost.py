"""The op-cost walk, the port's counterpart of
``repro/launch/hlo_analysis.py``.

The reference lowers a cell to XLA's optimized per-device HLO and re-walks
it: FLOPs of the dots and convolutions, HBM bytes as operand + result
bytes of every op that materialises (a fusion at its boundary, a
``dynamic-update-slice`` as its update), collective bytes, while bodies
times their trip count.  The port has no compiler program to read, so
:class:`Walk` runs the function itself over ``meta`` tensors (shapes, no
data) under a ``TorchDispatchMode`` and counts every ATen op it reaches,
backward and checkpoint recomputations included, per rank of a mesh:

* **FLOPs**: the matrix products' and convolutions', by the formulas of
  ``torch.utils.flop_counter``;
* **bytes**: the inputs plus the outputs of each op that materialises.
  Views, reshapes, ``empty`` and ``detach`` are free (``FREE_OPS``'
  counterpart); an in-place write into a slice (``index_put_``,
  ``scatter_``, ``copy_``, ...) counts its update twice and not the buffer
  (``_update_bytes``' rule);
* **the kernel boundary** (the fusion boundary's counterpart): while a
  walk is active each entry point of ``kernels/ops.py`` records
  ``kernels/cost.py``'s work for its call, on its first tensor's rank,
  then runs its plain version uncounted, only to give the outputs their
  shapes.  A call counts the same work whatever implements it;
* **ranks**: every rank's device is ``meta``, so the walk places tensors
  itself.  A tensor moved by ``launch/mesh.py to_rank`` / ``to_rank_of``
  (``place``, ``gather``, the training attention's blocks, the moe paths,
  ``lse_combine``) lies on the rank it was moved to, one made inside
  ``rank_scope(r)`` or marked ``on_rank(t, r)`` (a pool slab, a moe
  shard's buffer) on ``r``.  An in-place op runs where its target lies,
  any other op inside a rank scope on the scope's rank, else on its first
  tensor input's rank; a tensor made outside any scope lies on rank 0,
  where the port computes what an unplaced model computes but attention
  and moe.  An input on another rank is read there and its bytes count
  as **peer bytes** into the op's rank (the counterpart of collective
  wire bytes), by the path that moved it (``"gather"``, a placed
  weight's ZeRO-3 gather included, ``"place"``, ``"attention"``,
  ``"all-to-all"``, ``"moe"``, ``"sum"``, the partial sums over
  ``model``, ``"lse_combine"``; ``"other"`` for an operand read where it
  lies);
* **peak live bytes** per rank: every storage an op makes is live from
  its op until the storage is freed; ``peak_all`` is the peak of their sum
  over the ranks (what one device that holds every rank would hold).

The walk reckons ``meta`` tensors only: any other tensor in its ops
raises (a host scalar, an empty host tensor and a host array uploaded
onto ``meta`` excepted), and so does a kernel entry point's.  Outputs of
ops are made from a cache of each op's output layouts by its inputs'
(the meta kernels of elementwise ops are slow Python), so the walk
allocates nothing.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import weakref
from typing import Dict, List, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import cost
from repro_torch.launch import mesh as mesh_mod

aten = torch.ops.aten

#: ops that allocate without moving bytes
ALLOC_OPS = {aten.empty.memory_format, aten.empty_strided.default,
             aten.empty_like.default, aten.new_empty.default,
             aten.new_empty_strided.default}
#: in-place writes into a slice: their update counts twice, not the buffer
UPDATE_OPS = {aten.index_put_.default, aten._index_put_impl_.default,
              aten.scatter_.src, aten.scatter_.value,
              aten.scatter_add_.default, aten.scatter_reduce_.two,
              aten.index_copy_.default, aten.index_add_.default,
              aten.index_fill_.int_Scalar, aten.masked_scatter_.default,
              aten.copy_.default}
#: ops that may read a host tensor to put it on ``meta`` (an upload)
UPLOAD_OPS = {aten._to_copy.default, aten.copy_.default,
              aten.lift_fresh.default, aten.lift_fresh_copy.default}


class WalkError(ValueError):
    """What a walk refuses: a tensor that is not ``meta``."""


def _tensors(args, kwargs) -> List[torch.Tensor]:
    out = []
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.Tensor):
            out.append(a)
        elif isinstance(a, (list, tuple)):
            out.extend(x for x in a if isinstance(x, torch.Tensor))
    return out


def _outputs(out) -> List[torch.Tensor]:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (list, tuple)):
        return [x for x in out if isinstance(x, torch.Tensor)]
    return []


def _key(a):
    """A hashable stand-in for an argument's layout (raises TypeError
    where none exists)."""
    if isinstance(a, torch.Tensor):
        return (tuple(a.shape), a.stride(), a.dtype, a.device.type)
    if isinstance(a, (list, tuple)):
        return tuple(_key(x) for x in a)
    hash(a)
    return a


def _layout(t: torch.Tensor):
    return tuple(t.shape), t.stride(), t.dtype


@functools.lru_cache(maxsize=None)
def _writes_first(func) -> bool:
    """Whether ``func`` writes its first argument (an in-place op)."""
    args = func._schema.arguments
    info = args[0].alias_info if args else None
    return bool(info is not None and info.is_write)


@functools.lru_cache(maxsize=None)
def _aliases(func) -> bool:
    """Whether ``func``'s schema says a result aliases an input."""
    return any(r.alias_info is not None for r in func._schema.returns)


class _Move(torch.autograd.Function):
    """A copy onto another rank; its backward moves the grad back."""

    @staticmethod
    def forward(ctx, t, walk, rank, path, memory_format):
        ctx.walk, ctx.src, ctx.path = walk, walk.rank_of(t), path
        with walk._moving(rank, path):
            return t.clone(memory_format=memory_format)

    @staticmethod
    def backward(ctx, g):
        with ctx.walk._moving(ctx.src, ctx.path):
            return g.clone(), None, None, None, None


class _Join(torch.autograd.Function):
    """:meth:`Walk.join` under autograd: its backward hands each piece its
    slice of the grad on the piece's rank, counted to the join's path.
    Many joins read one piece (every rank's gather of a weight's ZeRO-3
    blocks), and autograd would sum their grads with an op a pair: the
    first grad a piece receives in a backward pass is a tensor of the
    piece's shape on its rank, and each later one is reckoned as that
    add (the buffer read and written again) and handed over as None, so
    the walk runs one op a piece, not one a reader and piece."""

    @staticmethod
    def forward(ctx, walk, rank, path, shape, indices, dtype, *tensors):
        ctx.walk, ctx.rank, ctx.path = walk, rank, path
        # each piece's autograd identity: its node and output, or a leaf
        edges = [None if not t.requires_grad else
                 (t.grad_fn, t.output_nr) if t.grad_fn is not None
                 else (t, 0) for t in tensors]
        # every rank joins the same pieces (a weight's blocks): their
        # description is made once and shared by the joins' contexts,
        # keyed by the pieces' nodes, which the entry holds (so their ids
        # stay unique while it lives)
        key = None if None in edges else \
            (tuple((id(e[0]), e[1]) for e in edges), indices, dtype)
        ctx.pieces = walk._join_pieces.get(key)
        if ctx.pieces is None:
            # a grad moves as the piece was read (``dtype``) and is summed
            # in the piece's own dtype where it lies
            ctx.pieces = tuple(
                (tuple(t.shape), t.dtype, walk.rank_of(t), edge,
                 _slice_bytes(t.shape, dtype or t.dtype, index),
                 _slice_bytes(t.shape, t.dtype, ()))
                for t, index, edge in zip(tensors, indices, edges))
            if key is not None:
                walk._join_pieces[key] = ctx.pieces
        return walk._join(list(zip(tensors, indices)), shape, rank, path,
                          dtype)

    @staticmethod
    def backward(ctx, g):
        walk, grads = ctx.walk, []
        task = torch._C._current_graph_task_id()
        for shape, dtype, src, edge, n, full in ctx.pieces:
            if edge is None:
                grads.append(None)
                continue
            key = (task, id(edge[0]), edge[1])
            first = key not in walk._grads_seen
            if first:
                walk._grads_seen.add(key)
                with walk._moving(src, ctx.path):
                    grads.append(torch.empty(shape, dtype=dtype,
                                             device="meta"))
            else:
                grads.append(None)
            if walk._counting:
                walk.bytes[ctx.rank] += n
                walk.bytes[src] += full if first else 3 * full
                if src != ctx.rank:
                    walk.peer[src] += n
                    walk.rank_paths[src][ctx.path] += n
        return (None,) * 6 + tuple(grads)


def _slice_bytes(shape, dtype, index) -> int:
    """Bytes of the slice ``index`` (leading step-1 slices) of a tensor of
    ``shape`` and ``dtype``."""
    n = dtype.itemsize
    for i, size in enumerate(shape):
        n *= len(range(*index[i].indices(size))) if i < len(index) else size
    return n


class _Mode(TorchDispatchMode):
    def __init__(self, walk: "Walk"):
        super().__init__()
        self.walk = walk

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        return self.walk._dispatch(func, args, kwargs or {})


class Walk:
    """One op-cost walk over ``n_ranks`` ranks.  Enter it, build the
    cell's tensors on ``meta`` inside (they are placed, nothing is
    counted), then :meth:`run` the function: the counts are of that call.
    ``fill``: the declared tokens each sequence of a serve state holds
    after a decode step's append (K2's shape-only form).  ``one_device``:
    the ranks share one device (a mesh of ranks on one card), so a move
    between ranks is the tensor itself, as ``.to`` of its own device
    returns it, not a copy (its bytes still count as peer bytes to its
    path): ``peak_all`` is then that device's peak."""

    def __init__(self, n_ranks: int = 1, *, fill: Optional[int] = None,
                 one_device: bool = False):
        self.n = int(n_ranks)
        self.one_device = one_device
        self.declared = {"fill": fill}
        self._cache: Dict = {}
        self._storages: Dict[int, list] = {}
        self._counting = False
        self._suspended = 0
        self._scope: Optional[int] = None
        self._dest: Optional[int] = None
        self._path = "other"
        #: the pieces a join's backward has handed a grad, by graph task
        self._grads_seen = set()
        #: the description of each set of pieces joined under autograd
        self._join_pieces: Dict = {}
        self._mode = _Mode(self)
        self.reset()

    # ------------------------------------------------------------------
    # the counts
    # ------------------------------------------------------------------
    def reset(self) -> None:
        """Zero every count (the rank tags stay)."""
        n = self.n
        self.flops = [0.0] * n
        self.bytes = [0.0] * n
        self.peer = [0.0] * n
        self.rank_paths = [collections.Counter() for _ in range(n)]
        self.kernels: Dict[str, Dict[str, float]] = {}
        self.live = [0] * n
        self.peak = [0] * n
        self.live_all = self.peak_all = 0
        self.arguments = [0] * n
        self.outputs = [0] * n
        self.aliased = [0] * n
        self.ops = 0

    @property
    def paths(self) -> collections.Counter:
        """Peer bytes by the path that moved them, over every rank."""
        return sum(self.rank_paths, collections.Counter())

    def rank_cost(self, rank: int) -> Dict[str, float]:
        """``hlo_analysis``'s keys for one rank: flops, HBM bytes,
        ``wire_bytes`` (its peer bytes), each path's peer bytes, and the
        peak live bytes."""
        return {"flops": self.flops[rank], "bytes": self.bytes[rank],
                "wire_bytes": self.peer[rank], **self.rank_paths[rank],
                "peak_bytes": self.peak[rank]}

    def terms(self, rank: int) -> Dict[str, float]:
        """Rank ``rank``'s roofline terms against the H100's peaks (s)."""
        return {"compute": self.flops[rank] / cost.BF16_FLOPS,
                "memory": self.bytes[rank] / cost.HBM_BYTES_PER_S,
                "collective": self.peer[rank] / cost.NVLINK_BYTES_PER_S}

    def busiest(self) -> int:
        """The rank whose largest term is the largest."""
        return max(range(self.n), key=lambda r: max(self.terms(r).values()))

    # ------------------------------------------------------------------
    # entering, running
    # ------------------------------------------------------------------
    def __enter__(self) -> "Walk":
        if mesh_mod.WALK is not None or cost.BOUNDARY is not None:
            raise RuntimeError("an op-cost walk is already active")
        mesh_mod.WALK, cost.BOUNDARY = self, self._boundary
        self._mode.__enter__()
        return self

    def __exit__(self, *exc) -> None:
        self._mode.__exit__(*exc)
        mesh_mod.WALK, cost.BOUNDARY = None, None

    def run(self, fn, arguments=()):
        """``fn()``, counted, with ``arguments`` (tensors, ``Sharded``
        values, and dicts / lists / tuples of them: what the call reads
        and the reference passes as the compiled function's arguments)
        live from the start.  Returns ``fn()``'s result; the counts are
        this walk's attributes."""
        if mesh_mod.WALK is not self:
            raise RuntimeError("enter the walk before running it")
        args = _leaves(arguments)
        for t in args:
            if not t.is_meta:
                raise WalkError(f"the walk reckons meta tensors only, not a "
                                f"{tuple(t.shape)} tensor on {t.device}")
        self.reset()
        self._grads_seen.clear()
        self._join_pieces.clear()
        for e in self._storages.values():
            e[2] = False
        seen = set()
        for t in args:
            key, e = self._entry(t)
            if key in seen:
                continue
            seen.add(key)
            e[2] = True
            self.arguments[e[0]] += e[1]
            self._grow(e[0], e[1])
        self._counting = True
        try:
            out = fn()
        finally:
            self._counting = False
        seen_out = set()
        for t in _leaves(out):
            key, e = self._entry(t)
            if key in seen_out:
                continue
            seen_out.add(key)
            self.outputs[e[0]] += e[1]
            if key in seen:
                self.aliased[e[0]] += e[1]
        return out

    @contextlib.contextmanager
    def scope(self, rank: int):
        """What runs inside runs on ``rank``."""
        prev, self._scope = self._scope, int(rank)
        try:
            yield
        finally:
            self._scope = prev

    # ------------------------------------------------------------------
    # ranks
    # ------------------------------------------------------------------
    def _entry(self, t: torch.Tensor):
        """(key, [rank, nbytes, counted, ref]) of ``t``'s storage,
        registered on rank 0 when the walk has not met it."""
        s = t.untyped_storage()
        key = s._cdata
        e = self._storages.get(key)
        if e is None:
            e = self._register(s, key, 0)
        return key, e

    def _register(self, s, key: int, rank: int) -> list:
        e = [rank, s.nbytes(), self._counting,
             weakref.ref(s, functools.partial(self._freed, key))]
        self._storages[key] = e
        if e[2]:
            self._grow(rank, e[1])
        return e

    def _freed(self, key: int, _ref) -> None:
        e = self._storages.pop(key, None)
        if e is not None and e[2]:
            self.live[e[0]] -= e[1]
            self.live_all -= e[1]

    def _grow(self, rank: int, n: int) -> None:
        self.live[rank] += n
        self.live_all += n
        if self.live[rank] > self.peak[rank]:
            self.peak[rank] = self.live[rank]
        if self.live_all > self.peak_all:
            self.peak_all = self.live_all

    def rank_of(self, t: torch.Tensor) -> int:
        """The rank ``t`` lies on (0 for one the walk has not placed)."""
        e = self._storages.get(t.untyped_storage()._cdata)
        return 0 if e is None else e[0]

    def tag(self, t: torch.Tensor, rank: int) -> None:
        """Place ``t``'s storage on ``rank`` (a tensor made on its
        device)."""
        s = t.untyped_storage()
        key = s._cdata
        e = self._storages.get(key)
        if e is None:
            self._register(s, key, int(rank))
        elif e[0] != rank:
            if e[2]:
                self.live[e[0]] -= e[1]
                self.live_all -= e[1]
                self._grow(int(rank), e[1])
            e[0] = int(rank)

    def move(self, t: torch.Tensor, rank: int, path: str = "other",
             memory_format=torch.preserve_format, copy: bool = False
             ) -> torch.Tensor:
        """``t`` on ``rank``: itself (or a copy, ``copy``) where it lies
        there already, else a copy whose bytes count to ``path``."""
        src = self.rank_of(t)
        if src == rank:
            return t.to(t.device, memory_format=memory_format, copy=copy)
        if self.one_device:
            with self._moving(int(rank), path):
                out = t.to(t.device, memory_format=memory_format, copy=copy)
            if out is t and self._counting:
                self.peer[rank] += cost.nbytes(t)
                self.rank_paths[rank][path] += cost.nbytes(t)
            return out
        if not torch.is_grad_enabled():
            with self._moving(int(rank), path):
                return t.clone(memory_format=memory_format)
        return _Move.apply(t, self, int(rank), path, memory_format)

    def join(self, pieces, shape, rank: int, path: str,
             dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        """The tensor of ``shape`` that ``launch.mesh.take`` joins on
        ``rank`` from ``pieces`` ((tensor, index) pairs, each piece the
        tensor's slice ``index``), counted as one op that reads every
        piece where it lies and writes the result (as a collective writes
        its output buffer): the bytes from other ranks count to ``path``.
        With ``dtype`` each piece is read as that dtype (cast where it
        lies: the bytes that move are the cast's), and so is the result.
        Reckoned from the shapes, without a view or a copy a piece; under
        autograd (a piece that requires grad) backward hands each piece
        its slice of the grad on the piece's rank, counted to ``path``."""
        tensors = [t for t, _ in pieces]
        if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
            return _Join.apply(self, int(rank), path, tuple(shape),
                               tuple(tuple(index) for _, index in pieces),
                               dtype, *tensors)
        return self._join(pieces, shape, int(rank), path, dtype)

    def _join(self, pieces, shape, rank: int, path: str,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
        with self._moving(rank, path):
            out = torch.empty(shape, dtype=dtype or pieces[0][0].dtype,
                              device="meta")
        if self._counting:
            self.bytes[rank] += cost.nbytes(out)
            for t, index in pieces:
                n = _slice_bytes(t.shape, dtype or t.dtype, index)
                src = self.rank_of(t)
                # the piece read where it lies (and its cast written there)
                self.bytes[src] += n if dtype is None else \
                    n + _slice_bytes(t.shape, t.dtype, index)
                if src != rank:
                    self.peer[rank] += n
                    self.rank_paths[rank][path] += n
        return out

    @contextlib.contextmanager
    def _moving(self, rank: int, path: str):
        prev = self._dest, self._path
        self._dest, self._path = rank, path
        try:
            yield
        finally:
            self._dest, self._path = prev

    def _rank_for(self, func, ins) -> int:
        if self._dest is not None:
            return self._dest
        if ins and _writes_first(func):
            return self.rank_of(ins[0])
        if self._scope is not None:
            return self._scope
        return self.rank_of(ins[0]) if ins else 0

    # ------------------------------------------------------------------
    # the ops
    # ------------------------------------------------------------------
    def _check(self, func, ins) -> None:
        for t in ins:
            # a host scalar, an empty host tensor (torch's checkpoint makes
            # one as a placeholder) or a host array uploaded holds nothing
            # the walk would miss
            if t.is_meta or (t.device.type == "cpu" and
                             (t.dim() == 0 or t.numel() == 0
                              or func in UPLOAD_OPS)):
                continue
            raise WalkError(f"the walk reckons meta tensors only: {func} "
                            f"met a {tuple(t.shape)} tensor on {t.device}")

    def _compute(self, func, args, kwargs):
        """``func``'s outputs, from the layout cache where it holds them,
        and whether they are fresh storages (None: not known)."""
        if _aliases(func) and not _writes_first(func):
            return func(*args, **kwargs), False
        try:
            key = (func, _key(args), _key(tuple(sorted(kwargs.items()))))
        except TypeError:
            return func(*args, **kwargs), None
        hit = self._cache.get(key)
        if hit is not None:
            if hit == "self":
                return args[0], False
            outs = [torch.empty_strided(s, st, dtype=dt, device="meta")
                    for s, st, dt in hit[1]]
            return (outs[0] if hit[0] else tuple(outs)), True
        out = func(*args, **kwargs)
        if _writes_first(func):
            if out is args[0]:
                self._cache[key] = "self"
            return out, False
        outs = _outputs(out)
        single = isinstance(out, torch.Tensor)
        if outs and len(outs) == (1 if single else len(out)) and \
                all(o.is_meta for o in outs):
            ins = {t.untyped_storage()._cdata
                   for t in _tensors(args, kwargs)}
            if not any(o.untyped_storage()._cdata in ins for o in outs):
                self._cache[key] = (single, [_layout(o) for o in outs])
                return out, True
        return out, None

    def _dispatch(self, func, args, kwargs):
        ins = _tensors(args, kwargs)
        self._check(func, ins)
        out, fresh = self._compute(func, args, kwargs)
        if self._suspended:
            return out
        outs = _outputs(out)
        rank = self._rank_for(func, ins)
        made = []
        if fresh is not False:
            held = set() if fresh else \
                {t.untyped_storage()._cdata for t in ins}
            for o in outs:
                if not o.is_meta:
                    continue
                s = o.untyped_storage()
                key = s._cdata
                if key not in held and key not in self._storages:
                    self._register(s, key, rank)
                    made.append(o)
        if self._counting:
            self._count(func, args, kwargs, ins, outs, made, rank)
        return out

    def _count(self, func, args, kwargs, ins, outs, made, rank) -> None:
        self.ops += 1
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops[rank] += float(flop_registry[packet](
                *args, **kwargs, out_val=outs[0] if len(outs) == 1
                else tuple(outs)))
        if func in ALLOC_OPS or (not made and not _writes_first(func)
                                 and func not in UPDATE_OPS):
            return      # a view, a reshape, detach: free
        metas = [t for t in ins if t.is_meta]
        if func in UPDATE_OPS:
            reads = metas[1:]
            written = sum(cost.nbytes(t) for t in reads)
        else:
            reads = metas
            written = sum(cost.nbytes(o) for o in outs if o.is_meta)
        self.bytes[rank] += written
        for t in reads:
            n = cost.nbytes(t)
            src = self.rank_of(t)
            self.bytes[src] += n
            if src != rank:
                self.peer[rank] += n
                self.rank_paths[rank][self._path if self._dest is not None
                                      else "other"] += n

    def _boundary(self, name: str, work, tensors, plain):
        """The kernel boundary (``kernels/cost.py BOUNDARY``)."""
        ts = [t for t in tensors if isinstance(t, torch.Tensor)]
        for t in ts:
            if not t.is_meta:
                raise WalkError(f"{name} under an op-cost walk takes meta "
                                f"tensors only, not one on {t.device}")
        rank = self._scope if self._scope is not None else \
            self.rank_of(ts[0])
        self._suspended += 1
        try:
            out = plain()
        finally:
            self._suspended -= 1
        for o in _outputs(out):
            s = o.untyped_storage()
            if s._cdata not in self._storages:
                self._register(s, s._cdata, rank)
        if self._counting:
            w = work(self.declared)
            self.flops[rank] += w.flops
            self.bytes[rank] += w.bytes
            k = self.kernels.setdefault(name, {"calls": 0, "bytes": 0,
                                               "flops": 0.0})
            k["calls"] += 1
            k["bytes"] += w.bytes
            k["flops"] += w.flops
            for t in ts:
                if self.rank_of(t) != rank:
                    self.peer[rank] += cost.nbytes(t)
                    self.rank_paths[rank]["other"] += cost.nbytes(t)
        return out


def _leaves(x) -> List[torch.Tensor]:
    """The tensors of a value: tensors, ``Sharded`` blocks, and dicts,
    lists and tuples of them."""
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, mesh_mod.Sharded):
        return list(x.blocks.values())
    if isinstance(x, dict):
        x = list(x.values())
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _leaves(v)]
    return []


__all__ = ["ALLOC_OPS", "UPDATE_OPS", "Walk", "WalkError"]
