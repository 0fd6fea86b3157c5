"""Serving engine: continuous batched greedy decode over a RowClone-managed
pool (port of ``repro/launch/serve.py``: the dense and moe families on one
GPU).

* ``add_request`` runs the prefill (K3 in every layer), writes the prompt's
  KV pages into the staging ring, and enqueues the stage→KV promotion
  (``OP_CROSS_POOL_COPY`` rows) on the engine's serve
  :class:`~repro_torch.core.stream.CommandStream`;
* ``fork`` shares every page by refcount (zero bytes move);
* ``decode_round`` captures the round's CoW splits and tail-block inits
  onto the same stream and flushes it: promotions, splits and inits drain
  as ONE fused launch (K1).  Then one decode step appends each sequence's
  K/V into its block and attends over the paged pool (K2 in every layer).

The staging ring is sized by the admission policy:
``admissions_per_round x max_blocks_per_seq`` slots unless
``max_admit_pages`` says otherwise (:data:`ServingEngine.FULL_TWIN` keeps
full-size staging twins).

CLI:  PYTHONPATH=src python -m repro_torch.launch.serve --smoke --device cpu
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import (DECODER_FAMILIES, ModelConfig,
                                 RowCloneConfig, get_config, list_archs)
from repro_torch.core.allocator import SubarrayAllocator
from repro_torch.core.cow_cache import PagedCoWCache
from repro_torch.core.rowclone import RowCloneEngine
from repro_torch.models.lm import LanguageModel, kv_to_pools, model_dtype
from repro_torch.models.paged import make_serving_pools
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


class ServingEngine:
    """Serving facade over RowCloneEngine + PagedCoWCache: admission
    (prefill + staged promotion), CoW fork, free, and greedy decode rounds
    whose bulk movement drains as one fused launch."""

    #: ``max_admit_pages`` value that keeps full-size staging twins
    FULL_TWIN = 0

    def __init__(self, cfg: ModelConfig, params: LanguageModel, *,
                 max_seqs: int = 16, max_blocks_per_seq: int = 64,
                 num_slabs: int = 4, rc: Optional[RowCloneConfig] = None,
                 max_admit_pages: Optional[int] = None,
                 admissions_per_round: int = 1, device="cuda"):
        if cfg.family == "vlm":
            raise NotImplementedError(VLM_REFUSAL)
        if cfg.family not in DECODER_FAMILIES:
            raise NotImplementedError(
                "the serving engine targets the "
                f"{' and '.join(DECODER_FAMILIES)} families; {cfg.family!r} "
                "decodes through LanguageModel.decode_state")
        self.device = resolve_device(device)
        if params.embed.device.type != self.device.type:
            raise ValueError(f"weights on {params.embed.device}, engine on "
                             f"{self.device}")
        self.cfg = cfg
        self.rc = rc or RowCloneConfig()
        self.model = params
        page = self.rc.page_size
        nblk = max_seqs * max_blocks_per_seq
        nblk = -(-nblk // num_slabs) * num_slabs
        if max_admit_pages is None:
            max_admit_pages = admissions_per_round * max_blocks_per_seq
        stage_nblk = nblk if max_admit_pages == self.FULL_TWIN \
            else int(max_admit_pages)
        alloc = SubarrayAllocator(
            nblk, num_slabs,
            reserved_zero_per_slab=self.rc.zero_blocks_per_slab)
        pools, group = make_serving_pools(
            cfg.num_attn_layers, nblk, page, cfg.num_kv_heads, cfg.head_dim,
            model_dtype(cfg), self.device, stage_nblk=stage_nblk)
        self.engine = RowCloneEngine(
            pools, alloc, enable_fpm=self.rc.enable_fpm,
            enable_psm=self.rc.enable_psm, enable_zi=self.rc.enable_zi,
            block_axis=1, group=group)
        self.cache = PagedCoWCache(self.engine, page, max_blocks_per_seq,
                                   max_seqs)
        self.last_logits: Dict[int, np.ndarray] = {}
        self.tokens: Dict[int, List[int]] = {}
        #: the round's bulk movement rides this stream (one launch/round)
        self.stream = self.engine.stream("serve")
        self.last_ticket = None
        #: per-admission stage→KV promotions still queued (free() retires)
        self._pending_promotions: Dict[int, List[Tuple[int, int]]] = {}

    # ------------------------------------------------------------------
    def add_request(self, prompt: np.ndarray) -> int:
        """Prefill ``prompt`` (S,) int32 into the staging ring and enqueue
        its promotion on the serve stream.  Returns the sequence id."""
        S = int(prompt.shape[0])
        with self.stream.capture():
            sid = self.cache.new_sequence(prompt_len=S)
        blocks = self.cache.blocks_of(sid)
        eng = self.engine
        stage_ids = eng.stage_blocks(len(blocks))
        try:
            tokens = torch.as_tensor(np.asarray(prompt, np.int64),
                                     device=self.device)[None]
            logits, k, v = self.model.prefill(tokens)
            ids = torch.as_tensor(stage_ids, device=self.device)
            for name, kv in (("k_stage", k), ("v_stage", v)):
                pool = eng.pools[name]
                pool.index_copy_(1, ids, kv_to_pools(kv, self.rc.page_size,
                                                     pool.dtype, len(blocks)))
            # out-of-band staging write: expires older tickets on these pools
            eng.mark_pools_written(("k_stage", "v_stage"))
        except Exception:
            eng.release_stage_blocks(stage_ids)
            self.cache.free_sequence(sid)
            raise
        pairs = list(zip(stage_ids, blocks))
        if pairs:
            self.stream.promote_staged(pairs)
        self._pending_promotions[sid] = pairs
        self.last_logits[sid] = logits[0].cpu().numpy()
        self.tokens[sid] = [int(t) for t in prompt]
        return sid

    def fork(self, sid: int, n: int) -> List[int]:
        """CoW-fork ``sid`` into ``n`` children (zero bytes move)."""
        with self.stream.capture():
            kids = self.cache.fork(sid, n)
        for c in kids:
            self.last_logits[c] = self.last_logits[sid].copy()
            self.tokens[c] = list(self.tokens[sid])
        return kids

    def free(self, sid: int) -> None:
        """Release a sequence: its still-queued promotions are RETIRED (a
        stale promotion would otherwise land in re-issued blocks), then its
        blocks, slot and host state."""
        pending = self._pending_promotions.pop(sid, None)
        if pending:
            self.engine.retire_promotions(pending)
        self.cache.free_sequence(sid)
        self.last_logits.pop(sid, None)
        self.tokens.pop(sid, None)

    def kv_bytes_live(self) -> int:
        """Primary-pool KV bytes backed by allocated blocks."""
        alloc = self.engine.alloc
        return (alloc.num_blocks - alloc.total_free()) * \
            self.engine._block_bytes()

    def pool_bytes_resident(self) -> int:
        """Bytes of every pool (K/V + staging ring)."""
        return self.engine.pool_bytes_resident()

    # ------------------------------------------------------------------
    def decode_round(self, sample_fn=None) -> Dict[int, int]:
        """One token for every live sequence: greedy, or
        ``sample_fn(logits)`` of each sequence's last logits (a numpy
        vector) when given."""
        live = sorted(self.cache.seqs)
        if not live:
            if len(self.stream):
                self.last_ticket = self.stream.flush()
            return {}
        next_tok = {sid: int(np.argmax(self.last_logits[sid]))
                    if sample_fn is None else sample_fn(self.last_logits[sid])
                    for sid in live}
        with self.stream.capture():
            self.cache.append_tokens(live)
        self.last_ticket = self.stream.flush()
        self._pending_promotions.clear()
        table, mask, base = self.cache.device_tables()
        B = self.cache.max_seqs
        toks = np.zeros((B,), np.int64)
        pos = np.zeros((B,), np.int64)
        for sid in live:
            slot = self.cache.slot_of(sid)
            toks[slot] = next_tok[sid]
            pos[slot] = self.cache.seqs[sid].length - 1
        eng = self.engine
        logits = self.model.decode_step(
            torch.from_numpy(toks).to(self.device),
            torch.from_numpy(pos).to(self.device), eng.pools["k"],
            eng.pools["v"], table, mask, base)
        # out-of-band decode-step append into the K/V pools
        eng.mark_pools_written(("k", "v"))
        logits = logits.cpu().numpy()
        for sid in live:
            self.last_logits[sid] = logits[self.cache.slot_of(sid)]
            self.tokens[sid].append(next_tok[sid])
        return next_tok


def main() -> None:
    """CLI: admit random prompts, optionally fork, greedy-decode, print the
    RowClone mechanism stats."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="llama3.2-3b", choices=list_archs(),
                    help="the engine serves the dense and moe configs; the "
                         "vlm, ssm and hybrid ones decode through "
                         "LanguageModel.decode_state and are refused here")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--fork", type=int, default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="serve the reduced (CPU-sized) configuration")
    ap.add_argument("--staging-ring", type=int, default=-1,
                    help="staging slots (max_admit_pages); 0 = full twin, "
                         "-1 = derive from the admission policy")
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
    t0 = time.perf_counter()
    for _ in range(args.steps):
        eng.decode_round()
    if eng.device.type == "cuda":
        torch.cuda.synchronize(eng.device)
    dt = time.perf_counter() - t0
    n_live = len(eng.cache.seqs)
    print(f"[serve] {args.steps} rounds x {n_live} seqs in {dt:.2f}s on "
          f"{eng.device} ({args.steps * n_live / dt:.1f} tok/s)")
    s = eng.engine.stats
    print(f"[serve] rowclone: fpm={s.fpm_copies} psm={s.psm_copies} "
          f"alias={s.alias_copies} lazy-zero={s.zero_lazy} "
          f"launches={s.launches} bytes_avoided={s.bytes_avoided}")


if __name__ == "__main__":
    main()
