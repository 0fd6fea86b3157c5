"""Serving engine: continuous batched greedy decode over a RowClone-managed
pool (port of ``repro/launch/serve.py``: the dense and moe families
served, the hybrid and encdec families admitted, on one device or over a
rank mesh, with whole or placed weights).

* ``add_request`` runs the prefill (K3 in every layer), writes the prompt's
  KV pages into the staging ring, and enqueues the stage→KV promotion
  (``OP_CROSS_POOL_COPY`` rows) on the engine's serve
  :class:`~repro_torch.core.stream.CommandStream`.  A hybrid or encdec
  prompt goes through the facade's ``prefill_state`` (an encdec's over
  zero source frames, as the reference's ``_prefill_batch``), and its
  per-sequence state that is not paged — the hybrid's conv / ssm state,
  the encdec's cross K/V — stays in ``_extras``;
* ``fork`` shares every page by refcount (zero bytes move);
* ``dedup_admit=True``: prompt pages whose chained fingerprint
  (:func:`page_fingerprint`) and tokens match a live registry entry share
  the donor's block by refcount instead of promoting their own copy;
* ``demote`` parks a sequence's blocks in the spill pools (cross-pool rows
  on the serve stream) and ``resume`` copies them back into fresh blocks;
* ``decode_round`` captures the round's CoW splits and tail-block inits
  onto the same stream and flushes it: promotions, demotions, resumes,
  splits and inits drain as ONE fused launch (K1).  Then one decode step
  appends each sequence's K/V into its block and attends over the paged
  pool (K2 in every layer).  The hybrid and encdec families decode
  through ``LanguageModel.decode_state``: ``decode_round`` refuses them,
  as the reference's does.

The staging ring is sized by the admission policy:
``admissions_per_round x max_blocks_per_seq`` slots unless
``max_admit_pages`` says otherwise (:data:`ServingEngine.FULL_TWIN` keeps
full-size staging twins); ``double_buffer=True`` doubles the slots, so a
burst of admissions past the nominal ring parks in the second half while
the first half's promotions are still queued.  The adaptive ring
(``adaptive_ring=True``) clamps the ring after :data:`RING_WINDOW` rounds
of low admission pressure and reopens it on demand.  ``fused_staging=False``
is the seed's A/B leg: no staging pools, the prefill's pages written
straight into the K/V pools (``RowCloneEngine.write_blocks``), eager CoW
work.

Fault tolerance: ``ckpt_pages > 0`` adds spill slots for a background
:class:`~repro_torch.checkpoint.PoolCheckpoint` ticked once per decode
round; ``fault_plan`` installs a :class:`~repro_torch.runtime.fault
.FaultPlan` against this engine; ``auto_recover=True`` catches a failed
round flush, checkpoint tick or admission and runs :meth:`ServingEngine
.recover` in place.  Admissions a recovery evicts land in
``evicted_sids`` for the caller to re-admit.

``mesh`` (a :class:`~repro_torch.launch.mesh.DeviceMesh`) holds every pool
as one slab per rank (ranks may share a device): the pool size rounds up
to a multiple of the shard count and the allocator's slabs, a ring or
spill window the shard count does not divide is replicated on every
rank, the decode batch shards over the mesh's (pod, data) axes into
``cache.batch_groups`` groups whose sequences keep their blocks in their
group's slabs, each round's bulk movement drains as one sharded drain (K7
hops and K1 per rank), and each layer's decode attention runs K2 once per
rank and LSE-combines the partials (models/paged.py).  A moe FFN takes
the path the mesh gives it, in prefill and decode alike (``models/moe.py
moe_ffn``: a prompt whose length the ``model`` axis divides goes through
the all-to-all over the experts).  The rest of the model (QKV, RoPE, a
dense FFN, logits) runs whole on the mesh's first device, unless the
weights are placed over the mesh (``weights.place_params``, every
family): each rank then computes its blocks of every layer in prefill and
decode, a moe layer's experts where they lie (the admission's one prompt,
which the data axes do not divide, and every decode step take the local
path: each batch group routes on its first rank and its ``model`` ranks
run their experts), and the logits come back joined on the first device
for sampling.  A placed hybrid or encdec prompt is admitted through the
placed ``prefill_state(mesh=)``, its slabs and placed state gathered
onto the engine's device as the unplaced admission holds them.  Prefill writes reach the slabs through
``RowCloneEngine.write_blocks``.

CLI:  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.checkpoint import CheckpointManager, PoolCheckpoint
from repro_torch.configs import (DECODER_FAMILIES, ModelConfig,
                                 RowCloneConfig, get_config, list_archs)
from repro_torch.core.allocator import SubarrayAllocator
from repro_torch.core.cow_cache import PagedCoWCache
from repro_torch.core.journal import RecoveryReport
from repro_torch.core.rowclone import RowCloneEngine
from repro_torch.kernels.fused_dispatch import notify_launch
from repro_torch.launch.mesh import (DeviceMesh, gather, pool_shard_count,
                                     pool_shard_ranks)
from repro_torch.models.lm import LanguageModel, kv_to_pools, model_dtype
from repro_torch.models.paged import batch_shard_count, make_serving_pools
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.autotune import backend_key, load_profile
from repro_torch.weights import init_params, resolve_device


#: why the engine refuses the vlm family
VLM_REFUSAL = (
    "the serving engine does not serve the vlm family: the reference's "
    "admission (src/repro/launch/serve.py:385-405) sizes a sequence as its "
    "text prompt and drops the vision_tokens patch positions that its "
    "prefill writes in front of it, so a prompt whose patches and text "
    "outgrow the prompt's pages fails to broadcast and decode appends over "
    "the text's KV at the wrong RoPE position; the vlm runs through "
    "LanguageModel.prefill_state / decode_state")

#: the families the engine admits: the decoders it serves, and the hybrid
#: and encdec, whose prompts it admits and whose decode runs through the
#: facade (the ssm family has no KV pages to stage)
ADMITTED_FAMILIES = DECODER_FAMILIES + ("hybrid", "encdec")
#: the per-sequence serve state outside the paged pools, kept in ``_extras``
EXTRA_KEYS = ("conv_state", "ssm_state", "cross_k", "cross_v")
#: the reference's ``decode_round`` refusal of the other families
DECODE_REFUSAL = ("CLI decode loop demo targets decoder-only archs; other "
                  "families decode through model.decode_step directly")

#: constructor arguments of the reference that the port does not take yet:
#: name -> (the reference's default, which means "off", and the ROADMAP
#: queue item that brings it); none is left
NOT_PORTED: Dict[str, Tuple[object, str]] = {}


@dataclasses.dataclass
class DemotedSeq:
    """Host-side record of a preempted sequence: what :meth:`ServingEngine
    .resume` needs to continue it bitwise-identically."""

    length: int                  #: sequence length at demotion time
    slots: List[int]             #: spill slots parking the KV bytes
    slab_home: int               #: preferred slab for re-allocation
    logits: np.ndarray           #: last logits (greedy argmax source)
    tokens: List[int]            #: token history (prompt + generated)
    extras: Optional[dict]       #: non-paged state (hybrid, encdec)


#: 64-bit fold constants (splitmix64 / FNV mixes) of the page fingerprint
_FP_MASK = (1 << 64) - 1
_FP_WORD = 0x9E3779B97F4A7C15
_FP_POS = 0xC2B2AE3D27D4EB4F
_FP_CHAIN = 0x100000001B3


def xor_fold(acc: int, word: int) -> int:
    """One XOR-fold step over 64-bit words, composed from the engine's
    bitwise opcode identities: ``x ^ y == (x | y) & ~(x & y)`` (an OR, an
    AND, a NOT and a final AND)."""
    both = acc & word
    either = acc | word
    return (either & (~both & _FP_MASK)) & _FP_MASK


def page_fingerprint(chain: int, tokens) -> int:
    """Chained fingerprint of one prompt page: position-salted token words
    folded with :func:`xor_fold` into the previous page's fingerprint
    (``chain``), so equal keys mean equal page *prefixes*; the page's token
    count is folded last, so a short tail page never aliases a full page
    that starts with the same tokens."""
    fp = chain & _FP_MASK
    for i, t in enumerate(tokens):
        word = ((int(t) + 1) * _FP_WORD + (i + 1) * _FP_POS) & _FP_MASK
        fp = xor_fold((fp * _FP_CHAIN) & _FP_MASK, word)
    return xor_fold(fp, (len(tokens) * _FP_POS) & _FP_MASK)


class ServingEngine:
    """Serving facade over RowCloneEngine + PagedCoWCache: admission
    (prefill + staged promotion, or the legacy direct write), dedup on
    admission, CoW fork, free, preemption by demotion, and greedy decode
    rounds whose bulk movement drains as one fused launch."""

    #: ``max_admit_pages`` value that keeps full-size staging twins
    FULL_TWIN = 0

    #: adaptive ring: rounds of low admission pressure before it shrinks
    RING_WINDOW = 4

    def __init__(self, cfg: ModelConfig, params: LanguageModel, *,
                 max_seqs: int = 16, max_blocks_per_seq: int = 64,
                 num_slabs: int = 4, rc: Optional[RowCloneConfig] = None,
                 fused_staging: bool = True,
                 max_admit_pages: Optional[int] = None,
                 admissions_per_round: int = 1, double_buffer: bool = False,
                 fault_plan=None, auto_recover: bool = False,
                 ckpt_pages: int = 0, ckpt_dir: Optional[str] = None,
                 ckpt_window: Optional[int] = None,
                 spill_pages: int = 0, dedup_admit: bool = False,
                 adaptive_ring: bool = True,
                 mesh: Optional[DeviceMesh] = None, device=None,
                 **not_ported):
        """``max_admit_pages`` sizes the staging ring (``None``: the tuned
        profile's ``ring_capacity`` where one is loaded, else the
        admission policy's ``admissions_per_round x max_blocks_per_seq``;
        :data:`FULL_TWIN`: full twins); ``double_buffer`` doubles it.
        ``ckpt_pages > 0`` adds that many spill slots for a
        :class:`PoolCheckpoint` in ``ckpt_dir`` (windows of
        ``min(ckpt_window, ckpt_pages)`` blocks), ``spill_pages > 0`` that
        many more for :meth:`demote` / :meth:`resume`: both share the
        spill pools, checkpoint windows in slots ``[0, ckpt_pages)``.
        ``fault_plan`` is installed against this engine; ``auto_recover``
        runs :meth:`recover` when a round's flush, checkpoint tick or
        admission fails.  ``dedup_admit`` and ``adaptive_ring`` apply to
        fused staging only.  ``mesh``: a :class:`DeviceMesh` whose ranks
        hold the pools' slabs (see the module docstring); the engine's
        device is then its first shard's, and ``device`` (default
        ``"cuda"`` without a mesh) must agree.  Arguments of
        :data:`NOT_PORTED` raise ``NotImplementedError`` unless they hold
        the reference's default (off)."""
        for name, value in not_ported.items():
            if name not in NOT_PORTED:
                raise TypeError(f"unexpected keyword argument {name!r}")
            off, item = NOT_PORTED[name]
            if not (type(value) is type(off) and value == off):
                raise NotImplementedError(
                    f"ServingEngine({name}={value!r}) is not ported yet: "
                    f"{item}")
        if cfg.family == "vlm":
            raise NotImplementedError(VLM_REFUSAL)
        if cfg.family not in ADMITTED_FAMILIES:
            raise NotImplementedError(
                f"the serving engine admits the {', '.join(ADMITTED_FAMILIES)}"
                f" families; {cfg.family!r} has no KV pages to stage and "
                "decodes through LanguageModel.decode_state")
        if mesh is not None and not isinstance(mesh, DeviceMesh):
            raise TypeError(f"mesh must be a DeviceMesh, not "
                            f"{type(mesh).__name__}")
        if mesh is None:
            self.device = resolve_device("cuda" if device is None
                                         else device)
        else:
            self.device = resolve_device(
                mesh.devices[pool_shard_ranks(mesh)[0]])
            if device is not None and \
                    resolve_device(device) != self.device:
                raise ValueError(f"device {device} is not the mesh's first "
                                 f"shard's {self.device}")
        if params.device.type != self.device.type:
            raise ValueError(f"weights on {params.device}, engine on "
                             f"{self.device}")
        params.check_placed(mesh)
        self.cfg = cfg
        self.rc = rc or RowCloneConfig()
        self.mesh = mesh
        self.model = params
        self.fused_staging = fused_staging
        self.double_buffer = double_buffer
        page = self.rc.page_size
        # the pool tiles both the allocator's slabs and the mesh's shards
        shards = pool_shard_count(mesh)
        align = math.lcm(num_slabs, shards)
        nblk = -(-max_seqs * max_blocks_per_seq // align) * align
        if max_admit_pages is None:
            # a tuned ring size applies only without an explicit kwarg
            # (kwarg > profile > the admission policy's derivation)
            prof = load_profile(backend_key(self.device))
            if prof is not None and prof.ring_capacity is not None:
                max_admit_pages = int(prof.ring_capacity)
        if max_admit_pages is None:
            max_admit_pages = admissions_per_round * max_blocks_per_seq
        if max_admit_pages == self.FULL_TWIN:
            self.ring_capacity = stage_nblk = nblk
        else:
            self.ring_capacity = int(max_admit_pages)
            stage_nblk = self.ring_capacity * (2 if double_buffer else 1)
        self.ckpt_pages = int(ckpt_pages)
        self.spill_pages = int(spill_pages)
        total_spill = self.ckpt_pages + self.spill_pages
        alloc = SubarrayAllocator(
            nblk, num_slabs,
            reserved_zero_per_slab=self.rc.zero_blocks_per_slab)
        # one PoolGroup of up to six pools (k, v, their staging ring and
        # their spill pools): K1 drains promotions, demotions and resumes
        # of a round in one launch.  K1's room (csrc/fused_dispatch.cu
        # kMaxPools = 16, kMaxPackBlocks = 46340) holds it: llama3.2-3b at
        # max_seqs 8 x 64 blocks with a 64-slot ring and 64 spill slots is
        # 2 x (512 + 64 + 64) = 1,280 blocks.  Under a mesh a ring or a
        # spill window that the shard count does not divide is held whole
        # on every rank instead of rounded up
        pools, group = make_serving_pools(
            cfg.num_attn_layers, nblk, page, cfg.num_kv_heads, cfg.head_dim,
            model_dtype(cfg), self.device, staging=fused_staging,
            stage_nblk=stage_nblk,
            replicate_staging=stage_nblk % shards != 0,
            ckpt_nblk=total_spill,
            replicate_ckpt=total_spill % shards != 0)
        self.engine = RowCloneEngine(
            pools, alloc, mesh=mesh, enable_fpm=self.rc.enable_fpm,
            enable_psm=self.rc.enable_psm, enable_zi=self.rc.enable_zi,
            block_axis=1, group=group)
        del pools       # under a mesh the engine holds slab copies
        # shard the decode batch over (pod, data) when the cache can pin
        # each sequence's blocks inside its group's slabs; otherwise keep
        # global share-mask columns (a replicated batch)
        dp = batch_shard_count(mesh, max_seqs)
        if dp > 1 and (num_slabs % dp or nblk % dp):
            dp = 1
        self.cache = PagedCoWCache(self.engine, page, max_blocks_per_seq,
                                   max_seqs, batch_groups=dp)
        self.last_logits: Dict[int, np.ndarray] = {}
        self.tokens: Dict[int, List[int]] = {}
        #: per-sequence state outside the pools (:data:`EXTRA_KEYS`)
        self._extras: Dict[int, Dict[str, torch.Tensor]] = {}
        #: the round's bulk movement rides this stream (one launch/round)
        self.stream = self.engine.stream("serve")
        self.last_ticket = None
        self.auto_recover = auto_recover
        self.fault_plan = fault_plan
        if fault_plan is not None:
            fault_plan.install(self.engine)
        #: admissions whose promotions have not drained (demote refuses;
        #: a recovery that lost the staged bytes evicts them)
        self._staged_sids: List[int] = []
        #: per-admission stage→KV promotions still queued (free() retires)
        self._pending_promotions: Dict[int, List[Tuple[int, int]]] = {}
        #: preempted sequences parked in spill slots, by sid
        self.demoted: Dict[int, DemotedSeq] = {}
        #: resumes whose spill→KV promotions have not drained (a recovery
        #: evicts them like staged admissions)
        self._resumed: List[Tuple[int, List[int]]] = []
        #: sequences a recovery evicted; re-admitting their prompts
        #: reproduces the KV bytes
        self.evicted_sids: List[int] = []
        #: demoted blocks held until the round's flush drains their reads
        self._free_after_flush: List[int] = []
        #: fused-staging admissions so far (donation-error injections
        #: name these ordinals)
        self._admission_ordinal = 0
        #: dedup registry: chained page fingerprint -> (donor block, page
        #: tokens); the tokens are checked on every hit
        self.dedup_admit = bool(dedup_admit) and fused_staging
        self._dedup_registry: Dict[int, Tuple[int, Tuple[int, ...]]] = {}
        #: registry keys per registering sid (free() drops them)
        self._dedup_keys: Dict[int, List[int]] = {}
        self.dedup_hits = 0           #: admissions that shared >= 1 page
        self.dedup_pages_shared = 0   #: prompt pages satisfied by sharing
        self.dedup_bytes_saved = 0    #: KV bytes those pages never took
        #: adaptive ring controller (fused staging only)
        self.adaptive_ring = bool(adaptive_ring) and fused_staging
        self._ring_window: List[int] = []   #: admitted pages, last rounds
        self._round_admitted_pages = 0
        self.ring_shrinks = 0         #: times the controller clamped it
        self.ring_regrows = 0         #: times demand reopened it
        self.last_recovery: Optional[RecoveryReport] = None
        self.pool_ckpt: Optional[PoolCheckpoint] = None
        if self.ckpt_pages:
            if ckpt_dir is None:
                raise ValueError("ckpt_pages > 0 needs ckpt_dir")
            # windows stay inside the checkpoint's slot range: with
            # demotion the spill pools are larger
            self.pool_ckpt = PoolCheckpoint(
                self.engine, CheckpointManager(ckpt_dir),
                window=(min(int(ckpt_window), self.ckpt_pages)
                        if ckpt_window is not None else self.ckpt_pages))
        if self.spill_pages:
            self.engine.enable_demotion(
                range(self.ckpt_pages, self.ckpt_pages + self.spill_pages))

    # ------------------------------------------------------------------
    def add_request(self, prompt: np.ndarray, stream=None) -> int:
        """Prefill ``prompt`` (S,) int32 into the staging ring and enqueue
        its promotion on the serve stream (or on ``stream``), or write it
        straight into the K/V pools (``fused_staging=False``).  Returns
        the sequence id."""
        stream = self.stream if stream is None else stream
        S = int(prompt.shape[0])
        if self.fused_staging:
            with stream.capture():
                sid = self.cache.new_sequence(prompt_len=S)
        else:
            sid = self.cache.new_sequence(prompt_len=S)
        blocks = self.cache.blocks_of(sid)
        eng = self.engine
        if not self.fused_staging:
            try:
                logits, pages, extras = self._prefill(prompt, len(blocks))
            except Exception:
                self.cache.free_sequence(sid)
                raise
            eng.alloc.mark_written(blocks)
            # the seed's leg: the prefill's pages straight into the K/V
            # pools, outside the command queue (the reference's is one jnp
            # scatter per pool, not a Pallas kernel)
            for name, kv in zip(("k", "v"), pages):
                eng.write_blocks(name, blocks, kv)
                notify_launch(len(blocks), 1, "legacy_stage")
            return self._admitted(sid, prompt, logits, extras)
        ordinal = self._admission_ordinal
        self._admission_ordinal += 1
        ceil = eng._stage_degraded_cap   # None = full capacity
        if self.adaptive_ring and eng.stage_limit is not None \
                and eng.stage_slots_free < len(blocks) \
                and (ceil is None or eng.stage_limit < ceil):
            # regrow on demand BEFORE reserving, up to a degraded
            # recovery's sticky cap: the clamp never fails or early-flushes
            # an admission the unclamped ring could hold
            eng.set_stage_limit(ceil)
            self.ring_regrows += 1
            self._ring_window = []
            obs_metrics.inc("serve.ring_regrows")
        stage_ids = eng.stage_blocks(len(blocks))
        try:
            if self.fault_plan is not None:
                # donation errors fire after the slots are reserved: the
                # staging pools die under the admission's prefill
                self.fault_plan.check_admission(ordinal, eng)
            logits, pages, extras = self._prefill(prompt, len(blocks))
            # out-of-band staging write (into every replica of a
            # replicated ring): expires older tickets on these pools
            for name, kv in zip(("k_stage", "v_stage"), pages):
                eng.write_blocks(name, stage_ids, kv)
        except Exception:
            eng.release_stage_blocks(stage_ids)
            if any(eng.pool_is_dead(n) for n in eng.staging):
                # the staging ring died: this admission (and any earlier
                # one whose promotion is queued) lost its staged bytes
                self.free(sid)
                self.evicted_sids.append(sid)
                if self.auto_recover:
                    self.recover()
            else:
                self.cache.free_sequence(sid)
            raise
        self._round_admitted_pages += len(stage_ids)
        pairs = list(zip(stage_ids, blocks))
        if self.dedup_admit:
            pairs = self._dedup_pages(sid, prompt, stage_ids, blocks)
        if pairs:
            stream.promote_staged(pairs)
        self._staged_sids.append(sid)
        self._pending_promotions[sid] = pairs
        return self._admitted(sid, prompt, logits, extras)

    def _prefill(self, prompt: np.ndarray, n_blocks: int
                 ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor],
                            Dict[str, torch.Tensor]]:
        """Prefill one prompt: its logits (1, V), its K and V pages
        (L, n_blocks, page, KVH, D) in the pools' dtype, and its state
        outside the pools (:data:`EXTRA_KEYS`; empty for dense and moe).
        The hybrid and encdec run the facade's prefill with no decode
        margin, whose pools come out in the identity layout of
        ``n_blocks`` blocks; an encdec reads zero source frames of
        ``max(S // src_frames_ratio, 1)`` (the reference's
        ``_prefill_batch``, ``serve.py:382-392``)."""
        cfg, page = self.cfg, self.rc.page_size
        tokens = torch.as_tensor(np.asarray(prompt, np.int64),
                                 device=self.device)[None]
        if cfg.family in DECODER_FAMILIES:
            logits, k, v = self.model.prefill(tokens, self.mesh)
            if self.model.placement is not None:
                # one batch group: the prompt's stacks on its first rank
                (k,), (v,) = k, v
            dtype = self.engine.group["k"].dtype
            return logits, (kv_to_pools(k, page, dtype, n_blocks),
                            kv_to_pools(v, page, dtype, n_blocks)), {}
        extra = {}
        if cfg.family == "encdec":
            extra["src_embeds"] = torch.zeros(
                (1, max(len(prompt) // cfg.src_frames_ratio, 1),
                 cfg.d_model), dtype=torch.float32, device=self.device)
        if self.model.placement is None:
            logits, st = self.model.prefill_state(tokens, margin_tokens=0,
                                                  **extra)
            return logits, (st["k_pools"], st["v_pools"]), \
                {k: st[k] for k in EXTRA_KEYS if k in st}
        # a placed model prefills over its mesh: its slabs and its placed
        # recurrent / cross state come back whole onto the engine's device,
        # as the unplaced admission delivers them
        logits, st = self.model.prefill_state(tokens, margin_tokens=0,
                                              mesh=self.mesh, **extra)
        pools = tuple(torch.cat([s.to(self.device) for s in (
            st[key] if isinstance(st[key], list) else [st[key]])], dim=1)
            for key in ("k_pools", "v_pools"))
        return logits, pools, {k: gather(st[k], self.device)
                               for k in EXTRA_KEYS if k in st}

    def _admitted(self, sid: int, prompt: np.ndarray, logits: torch.Tensor,
                  extras: Dict[str, torch.Tensor]) -> int:
        self.last_logits[sid] = logits[0].cpu().numpy()
        self.tokens[sid] = [int(t) for t in prompt]
        if extras:
            self._extras[sid] = extras
        return sid

    def _dedup_pages(self, sid: int, prompt: np.ndarray,
                     stage_ids: List[int],
                     blocks: List[int]) -> List[Tuple[int, int]]:
        """Collapse this admission's prompt pages onto registered donor
        blocks where the chained fingerprints and tokens match.  Returns
        the surviving (stage slot, block) promotions; matched pages share
        the donor by refcount and their slots return to the ring, and
        unmatched pages register as donors (the registry holds its own
        refcount on each).  Under sharded batches a donor is shared only
        into a sequence of its own batch group."""
        cache = self.cache
        group = cache.seqs[sid].group
        page = cache.page
        new_blocks = list(blocks)
        keep: List[Tuple[int, int]] = []
        released: List[int] = []
        registered: List[int] = []
        chain = 0
        for j, b in enumerate(blocks):
            toks = tuple(int(t) for t in prompt[j * page:(j + 1) * page])
            chain = page_fingerprint(chain, toks)
            hit = self._dedup_registry.get(chain)
            if hit is not None and hit[1] == toks and (
                    cache.batch_groups == 1
                    or cache.group_of_block(hit[0]) == group):
                self.engine.alloc.share([hit[0]])
                new_blocks[j] = hit[0]
                released.append(stage_ids[j])
                self.dedup_pages_shared += 1
                self.dedup_bytes_saved += self.engine._block_bytes()
            else:
                keep.append((stage_ids[j], b))
                if hit is None:
                    self.engine.alloc.share([b])
                    self._dedup_registry[chain] = (b, toks)
                    registered.append(chain)
        if registered:
            self._dedup_keys[sid] = registered
        if released:
            self.dedup_hits += 1
            self.engine.release_stage_blocks(released)
            self.cache.remap_blocks(sid, new_blocks)
        return keep

    def fork(self, sid: int, n: int) -> List[int]:
        """CoW-fork ``sid`` into ``n`` children (zero bytes move).  The
        eager cross-group copies of a sharded batch's fork are captured on
        the serve stream and drain with the round."""
        if self.fused_staging:
            with self.stream.capture():
                kids = self.cache.fork(sid, n)
        else:
            kids = self.cache.fork(sid, n)
        for c in kids:
            self.last_logits[c] = self.last_logits[sid].copy()
            self.tokens[c] = list(self.tokens[sid])
            # the children share the parent's tensors, as the reference
            # shares its immutable arrays: safe only because the engine
            # never decodes these families (LanguageModel.decode_state
            # updates a state's tensors in place)
            if sid in self._extras:
                self._extras[c] = self._extras[sid]
        return kids

    def free(self, sid: int) -> None:
        """Release a sequence: a demoted one releases its spill slots; a
        live one drops its dedup registry entries, RETIRES its still-queued
        promotions (a stale promotion would land in re-issued blocks) but
        keeps those into blocks a live dedup sharer still holds, then
        releases its blocks, slot and host state (``_extras`` included)."""
        parked = self.demoted.pop(sid, None)
        if parked is not None:
            self.engine.release_spill_slots(parked.slots)
            self._extras.pop(sid, None)
            return
        for key in self._dedup_keys.pop(sid, []):
            blk, _ = self._dedup_registry.pop(key)
            self.engine.alloc.free([blk])
        pending = self._pending_promotions.pop(sid, None)
        if pending and self.dedup_admit:
            pending = [(s, d) for s, d in pending
                       if not self.engine.alloc.is_shared(d)]
        if pending:
            self.engine.retire_promotions(pending)
        if sid in self._staged_sids:
            self._staged_sids.remove(sid)
        self.cache.free_sequence(sid)
        self.last_logits.pop(sid, None)
        self.tokens.pop(sid, None)
        self._extras.pop(sid, None)

    # ------------------------------------------------------------------
    def demote(self, sid: int, stream=None) -> None:
        """Preempt ``sid``: enqueue the copy of its blocks into spill slots
        and release its batch slot.  The blocks stay allocated until the
        round's flush has drained their reads.  A sequence admitted this
        round (promotion still queued) is refused."""
        if sid in self._staged_sids:
            raise RuntimeError(
                f"cannot demote seq {sid}: its admission promotion has "
                "not drained yet (preempt it next round)")
        stream = self.stream if stream is None else stream
        seq = self.cache.seqs[sid]
        blocks = list(seq.blocks)
        # the decode step writes the pools out of band of the allocator's
        # ZI metadata: mark the blocks written so the copy moves the bytes
        self.engine.alloc.mark_written(blocks)
        slots = stream.demote_to_spill(blocks)
        self.demoted[sid] = DemotedSeq(
            length=seq.length, slots=list(slots), slab_home=seq.slab_home,
            logits=self.last_logits.pop(sid),
            tokens=self.tokens.pop(sid, []),
            extras=self._extras.pop(sid, None))
        # hold the blocks past free_sequence until the flush
        self.engine.alloc.share(blocks)
        self.cache.free_sequence(sid)
        self._free_after_flush.extend(blocks)

    def resume(self, sid: int, stream=None) -> int:
        """Un-park a demoted sequence into fresh blocks (same slab
        preference) through a spill→KV promotion; returns its NEW sid."""
        d = self.demoted.pop(sid)
        stream = self.stream if stream is None else stream
        with stream.capture():
            new_sid = self.cache.new_sequence(prompt_len=d.length,
                                              prefer_slab=d.slab_home)
        blocks = self.cache.blocks_of(new_sid)
        assert len(blocks) == len(d.slots), (len(blocks), len(d.slots))
        stream.promote_spilled(list(zip(d.slots, blocks)))
        self.last_logits[new_sid] = d.logits
        self.tokens[new_sid] = d.tokens
        if d.extras is not None:
            self._extras[new_sid] = d.extras
        self._resumed.append((new_sid, list(d.slots)))
        return new_sid

    # ------------------------------------------------------------------
    def recover(self) -> RecoveryReport:
        """Return the serving engine to a clean state after a failed
        flush, checkpoint tick or admission: ``RowCloneEngine.recover``
        with the serving policy around it.

        The latest pool checkpoint (when one exists) restores killed K/V
        pools; a killed double-buffered staging ring comes back at
        single-buffer capacity (the degraded mode); admissions whose
        staged bytes were lost (a killed ring, or promotions evicted from
        the queues), in-flight resumes, and demoted sequences whose spill
        pools died are freed into ``evicted_sids``.  Aborted flushes'
        suffixes re-drain inside the engine call, completing promotions
        that had already dispatched."""
        eng = self.engine
        staging_dead = any(eng.pool_is_dead(n) for n in eng.staging)
        # probe the spill pools BEFORE the engine resurrects them: dead
        # spill pools take every demoted sequence's parked bytes along
        spill_dead = self.spill_pages > 0 and any(
            eng.pool_is_dead(s.name) for s in eng.group
            if s.role == "spill")
        degraded = None
        if staging_dead and self.double_buffer:
            degraded = self.ring_capacity
        snap = self.pool_ckpt.latest() if self.pool_ckpt is not None \
            else None
        rep = eng.recover(snapshot=snap, degraded_stage_capacity=degraded)
        if self.pool_ckpt is not None:
            self.pool_ckpt.reset()
        if staging_dead or rep.evicted_promotions:
            for sid in list(self._staged_sids):
                if sid in self.cache.seqs:
                    self.free(sid)
                    self.evicted_sids.append(sid)
        # the aborted queues dropped the demote reads: release the blocks
        # held for them now
        if self._free_after_flush:
            eng.alloc.free(self._free_after_flush)
            self._free_after_flush = []
        for sid, slots in self._resumed:
            if sid in self.cache.seqs:
                self.free(sid)
                self.evicted_sids.append(sid)
            eng.release_spill_slots(slots)
        self._resumed = []
        if spill_dead:
            for sid in list(self.demoted):
                self.free(sid)
                self.evicted_sids.append(sid)
        self._staged_sids = []
        self._pending_promotions.clear()
        self.last_ticket = None
        self.last_recovery = rep
        return rep

    # ------------------------------------------------------------------
    def kv_bytes_live(self) -> int:
        """Primary-pool KV bytes backed by allocated blocks."""
        alloc = self.engine.alloc
        return (alloc.num_blocks - alloc.total_free()) * \
            self.engine._block_bytes()

    def pool_bytes_resident(self) -> int:
        """Bytes of every pool (K/V, staging ring, spill pools)."""
        return self.engine.pool_bytes_resident()

    def _post_flush(self) -> None:
        """Round-boundary bookkeeping after the serve stream's flush:
        nothing is in flight any more, demoted blocks go back to the
        allocator, and the adaptive ring takes its sample."""
        self._staged_sids = []
        self._pending_promotions.clear()
        self._resumed = []
        if self._free_after_flush:
            self.engine.alloc.free(self._free_after_flush)
            self._free_after_flush = []
        eng = self.engine
        if not eng.staging:
            return
        effective = eng.stage_limit if eng.stage_limit is not None \
            else eng.stage_capacity
        in_use = eng.stage_capacity - eng.stage_slots_free \
            - len(eng._stage_parked)
        obs_metrics.set_gauge("serve.ring_occupancy", in_use)
        obs_metrics.set_gauge("serve.ring_limit", effective)
        if not self.adaptive_ring:
            return
        self._ring_window.append(self._round_admitted_pages)
        self._round_admitted_pages = 0
        if len(self._ring_window) < self.RING_WINDOW:
            return
        peak = max(self._ring_window)
        self._ring_window = []
        # a whole window at <= half the usable ring: clamp to 2x its peak
        if effective > 1 and peak <= effective // 2:
            new_limit = max(2 * peak, 1)
            if new_limit < effective:
                eng.set_stage_limit(new_limit)
                self.ring_shrinks += 1
                obs_metrics.inc("serve.ring_shrinks")

    def decode_round(self, sample_fn=None) -> Dict[int, int]:
        """One token for every live sequence: greedy, or
        ``sample_fn(logits)`` of each sequence's last logits (a numpy
        vector) when given.  With no live sequence the round still drains
        the stream (demotions must land).  The hybrid and encdec families
        are refused, as the reference refuses them."""
        if self.cfg.family not in DECODER_FAMILIES:
            raise NotImplementedError(DECODE_REFUSAL)
        live = sorted(self.cache.seqs)
        if not live:
            if len(self.stream):
                try:
                    self.last_ticket = self.stream.flush()
                except Exception:
                    if not self.auto_recover:
                        raise
                    self.recover()
                self._post_flush()
            return {}
        next_tok = {sid: int(np.argmax(self.last_logits[sid]))
                    if sample_fn is None else sample_fn(self.last_logits[sid])
                    for sid in live}
        if self.fused_staging:
            with self.stream.capture():
                self.cache.append_tokens(live)
        else:
            self.cache.append_tokens(live)      # legacy leg: eager
        try:
            self.last_ticket = self.stream.flush()
        except Exception:
            if not self.auto_recover:
                raise
            # the aborted flush's suffix re-drains inside recover() (same
            # rows, same bytes), so this round decodes as the clean run
            self.recover()
            live = [s for s in live if s in self.cache.seqs]
            next_tok = {s: next_tok[s] for s in live}
            if not live:
                return {}
        self._post_flush()
        table, mask, base = self.cache.device_tables()
        B = self.cache.max_seqs
        toks = np.zeros((B,), np.int64)
        pos = np.zeros((B,), np.int64)
        for sid in live:
            slot = self.cache.slot_of(sid)
            toks[slot] = next_tok[sid]
            pos[slot] = self.cache.seqs[sid].length - 1
        eng = self.engine
        # the appends go into the slabs themselves (under a mesh
        # ``eng.pools`` would gather a copy)
        logits = self.model.decode_step(
            torch.from_numpy(toks).to(self.device),
            torch.from_numpy(pos).to(self.device), eng.slabs("k"),
            eng.slabs("v"), table, mask, base, mesh=self.mesh)
        # out-of-band decode-step append into the K/V pools
        eng.mark_pools_written(("k", "v"))
        logits = logits.cpu().numpy()
        for sid in live:
            self.last_logits[sid] = logits[self.cache.slot_of(sid)]
            self.tokens[sid].append(next_tok[sid])
        if self.pool_ckpt is not None:
            # one checkpoint window a round on the ckpt stream, harvested
            # next round
            try:
                self.pool_ckpt.step()
            except Exception:
                if not self.auto_recover:
                    raise
                self.recover()
        return next_tok


def main() -> None:
    """CLI: admit random prompts, optionally fork, greedy-decode, print the
    RowClone mechanism stats."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b", choices=list_archs(),
                    help="the engine serves the dense and moe configs; it "
                         "admits the hybrid and encdec ones, whose decode "
                         "rounds it refuses, and refuses the vlm and ssm "
                         "ones (all four decode through "
                         "LanguageModel.decode_state)")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--fork", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="serve the reduced (CPU-sized) configuration")
    ap.add_argument("--staging-ring", type=int, default=-1,
                    help="staging slots (max_admit_pages); 0 = full twin, "
                         "-1 = derive from the admission policy")
    ap.add_argument("--double-buffer", action="store_true",
                    help="double-buffered staging ring: admission bursts "
                         "past the ring capacity park in the second half "
                         "at one launch per round")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.reduced()
    params = init_params(cfg, seed=args.seed, device=args.device)
    eng = ServingEngine(cfg, params, max_seqs=max(args.requests * 4, 8),
                        max_admit_pages=(None if args.staging_ring < 0
                                         else args.staging_ring),
                        double_buffer=args.double_buffer,
                        device=args.device)
    print(f"[serve] resident pool bytes: "
          f"{eng.pool_bytes_resident() / 1e6:.1f} MB (staging slots: "
          f"{eng.engine.stage_capacity} of {eng.engine.num_blocks} KV "
          "blocks)")
    rng = np.random.default_rng(args.seed)
    sids = []
    for _ in range(args.requests):
        p = rng.integers(2, cfg.vocab_size, size=args.prompt_len)
        sids.append(eng.add_request(p.astype(np.int32)))
        print(f"[serve] admitted seq {sids[-1]} ({args.prompt_len} tokens)")
    if args.fork:
        kids = eng.fork(sids[0], args.fork)
        print(f"[serve] forked seq {sids[0]} -> {kids} (CoW shares: "
              f"{eng.engine.alloc.stats.cow_shares})")
    with obs_metrics.Stopwatch() as sw:
        for _ in range(args.steps):
            eng.decode_round()
        if eng.device.type == "cuda":
            torch.cuda.synchronize(eng.device)
    dt = sw.s
    n_live = len(eng.cache.seqs)
    print(f"[serve] {args.steps} rounds x {n_live} seqs in {dt:.2f}s on "
          f"{eng.device} ({args.steps * n_live / dt:.1f} tok/s)")
    s = eng.engine.stats
    print(f"[serve] rowclone: fpm={s.fpm_copies} psm={s.psm_copies} "
          f"alias={s.alias_copies} lazy-zero={s.zero_lazy} "
          f"launches={s.launches} bytes_avoided={s.bytes_avoided}")


if __name__ == "__main__":
    main()
