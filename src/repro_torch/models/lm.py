"""The language model (port of ``repro/models/lm.py``) for every family of
the reference: dense, moe, vlm, ssm, hybrid and encdec.  Each family
decodes through one pair (:data:`ENTRY_PAIRS`):

* dense and moe: :meth:`LanguageModel.prefill` over a prompt and
  :meth:`LanguageModel.decode_step` over the paged pools, the pair the
  serving engine drives;
* vlm, ssm, hybrid and encdec: the facade pair of the reference's
  ``prefill`` / ``decode_step`` — :meth:`LanguageModel.prefill_state`
  returns the last-position logits and the serve state
  (``make_serve_state``'s keys), :meth:`LanguageModel.decode_state` takes
  one token per sequence over it.  The serving engine admits hybrid and
  encdec prompts through ``prefill_state`` but decodes none of these
  families, as the reference's ``decode_round`` refuses them; the
  reference's admission drops a vlm prompt's patch positions, so the
  port's engine refuses vlm (``launch/serve.py``).

Every family trains through :meth:`LanguageModel.loss_fn` (the module's
``forward``): the reference's ``_backbone_train`` and ``loss_fn``, with
autograd, no kernel and the stacks checkpointed.  The serving pairs run
under ``torch.no_grad``.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs import (DECODER_FAMILIES, ModelConfig,
                                 RowCloneConfig)
from repro_torch.launch.mesh import (DeviceMesh, on_rank, pool_shard_count,
                                     pool_shard_ranks)
from repro_torch.models.attention import MaskInfo
from repro_torch.models.common import (checkpointed, chunked_softmax_xent,
                                       embed, rms_norm)
from repro_torch.models.mamba2 import (Mamba2Layer, mamba2_decode_step,
                                       mamba2_layer)
from repro_torch.models.paged import (batch_shard_count, identity_layout,
                                     rank_appends)
from repro_torch.models.transformer import (DecoderLayer, attn_block_train,
                                            cross_block_train,
                                            decoder_layer_decode,
                                            decoder_layer_train,
                                            decoder_stack_train, remat_call)

#: the families each entry pair takes: the engine's pair (``prefill`` /
#: ``decode_step``) and the facade's (``prefill_state`` / ``decode_state``
#: / ``make_serve_state``)
ENTRY_PAIRS = {"prefill / decode_step": DECODER_FAMILIES,
               "prefill_state / decode_state": ("vlm", "ssm", "hybrid",
                                                "encdec")}
PORTED_FAMILIES = tuple(f for fams in ENTRY_PAIRS.values() for f in fams)


def model_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


class LanguageModel(nn.Module):
    """Weights of the model: embedding (tied to the head when
    ``cfg.tie_embeddings``), final norm and the layers — decoder layers
    (dense, moe, vlm; encdec with cross-attention) or Mamba2 layers (ssm,
    hybrid), plus the one shared decoder layer of the hybrid, which runs
    after every ``shared_attn_every`` Mamba2 layers, and the encoder of an
    encdec (``enc_layers``, ``encoder_layers`` decoder layers run without
    the causal mask, and its norm ``enc_norm``).  Build one with
    :func:`repro_torch.weights.init_params` or
    :func:`repro_torch.weights.from_jax_params`.  The matrices are in
    ``param_dtype`` (default the model dtype; fp32 for training, whose
    forward reads bf16 views of them, ``launch/train.py``), the norm
    gains, the Mamba2 conv and SSD parameters in fp32."""

    def __init__(self, cfg: ModelConfig, device,
                 rc: RowCloneConfig = RowCloneConfig(),
                 param_dtype: Optional[torch.dtype] = None):
        super().__init__()
        if cfg.family not in PORTED_FAMILIES:
            raise ValueError(f"unknown family {cfg.family!r}")
        self.cfg = cfg
        self.page = rc.page_size
        dt = param_dtype or model_dtype(cfg)
        self.embed = nn.Parameter(
            torch.zeros((cfg.padded_vocab, cfg.d_model), dtype=dt,
                        device=device), requires_grad=False)
        self.final_norm = nn.Parameter(
            torch.zeros((cfg.d_model,), dtype=torch.float32, device=device),
            requires_grad=False)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(
                torch.zeros((cfg.d_model, cfg.padded_vocab), dtype=dt,
                            device=device), requires_grad=False)
        if cfg.family in ("ssm", "hybrid"):
            self.layers = nn.ModuleList(Mamba2Layer(cfg, dt, device)
                                        for _ in range(cfg.num_layers))
        else:
            cross = cfg.family == "encdec"
            self.layers = nn.ModuleList(DecoderLayer(cfg, dt, device, cross)
                                        for _ in range(cfg.num_layers))
        if cfg.family == "hybrid":
            self.shared = DecoderLayer(cfg, dt, device)
        if cfg.family == "encdec":
            self.enc_layers = nn.ModuleList(
                DecoderLayer(cfg, dt, device)
                for _ in range(cfg.encoder_layers))
            self.enc_norm = nn.Parameter(
                torch.zeros((cfg.d_model,), dtype=torch.float32,
                            device=device), requires_grad=False)

    @property
    def act_dtype(self) -> torch.dtype:
        return model_dtype(self.cfg)

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """The head is a bf16 product whatever the config dtype (as
        ``lm.py:94-98`` of the reference); logits come back fp32."""
        w = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return (x.to(torch.bfloat16) @ w.to(torch.bfloat16)).float()

    # ------------------------------------------------------------------
    # training forward (full sequence; the reference's _backbone_train)
    # ------------------------------------------------------------------
    def forward(self, batch: Dict[str, torch.Tensor],
                remat: str = "minimal", mesh: Optional[DeviceMesh] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The module's forward is the training loss (:meth:`loss_fn`)."""
        return self.loss_fn(batch, remat, mesh)

    def loss_fn(self, batch: Dict[str, torch.Tensor],
                remat: str = "minimal", mesh: Optional[DeviceMesh] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The training loss of a ``data.make_batch`` batch on this
        model's device: ``tokens`` / ``labels`` / ``mask`` (B, S), a vlm's
        ``patch_embeds`` and an encdec's ``src_embeds``.  Returns (total,
        {"loss", "aux"}): the masked mean cross-entropy with its z-loss
        (``common.chunked_softmax_xent``), the moe layers' aux losses
        summed (0 for the other families), ``total = loss + 1e-2 aux``.
        ``remat`` names the decoder stack's policy
        (``transformer.REMAT_POLICIES``).  Over ``mesh`` every decoder
        stack (the hybrid's shared block too) runs its training attention
        by blocks on their ranks and a moe FFN by its mesh path, under the
        active rules; the rest runs whole on the model's device.
        Differentiable; no kernel runs (the training attention and SSD
        term are model-level functions)."""
        cfg = self.cfg
        x, aux, prefix = self._backbone_train(batch, remat, mesh)
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        if prefix:
            x = x[:, prefix:, :]
        w = self.embed.T if cfg.tie_embeddings else self.lm_head
        loss = chunked_softmax_xent(x, w, batch["labels"], batch["mask"])
        total = loss + 1e-2 * aux
        return total, {"loss": loss, "aux": aux}

    def _backbone_train(self, batch: Dict[str, torch.Tensor], remat: str,
                        mesh: Optional[DeviceMesh] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, int]:
        """(final hidden (B, S, d) before the final norm, aux loss fp32,
        the length of the patch prefix to drop before the loss)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        x = embed(self.embed, tokens.long(), self.act_dtype)
        prefix = 0
        if cfg.family == "vlm":
            patches = batch["patch_embeds"].to(x.dtype)
            x = torch.cat([patches, x], dim=1)
            prefix = patches.shape[1]
        B, S, _ = x.shape
        pos = torch.arange(S, device=x.device).expand(B, S)
        info = MaskInfo(causal=True, prefix_len=prefix)
        zero = torch.zeros((), dtype=torch.float32, device=x.device)
        if cfg.family in ("dense", "moe", "vlm"):
            x, aux = decoder_stack_train(self.layers, x, pos, cfg, info,
                                         remat=remat, mesh=mesh)
            return x, aux, prefix
        if cfg.family == "ssm":
            return self._mamba_stack_train(x), zero, 0
        if cfg.family == "hybrid":
            x, aux = self._hybrid_stack_train(x, pos, info, remat, mesh)
            return x, aux, 0
        # encdec: the encoder over the source frames, then the decoder
        # with cross-attention
        enc = batch["src_embeds"].to(x.dtype)
        B_e, S_src, _ = enc.shape
        pos_e = torch.arange(S_src, device=x.device).expand(B_e, S_src)
        enc, _ = decoder_stack_train(self.enc_layers, enc, pos_e, cfg,
                                     MaskInfo(causal=False), remat=remat,
                                     mesh=mesh)
        enc = rms_norm(enc, self.enc_norm, cfg.norm_eps)
        x, aux = decoder_stack_train(self.layers, x, pos, cfg, info,
                                     enc_out=enc, remat=remat, mesh=mesh)
        return x, aux, 0

    def _mamba_stack_train(self, x: torch.Tensor) -> torch.Tensor:
        """The ssm stack: every layer checkpointed, whatever the policy
        (the reference's ``nothing_saveable`` scan body)."""
        def body(layer, h):
            return mamba2_layer(layer, h, self.cfg, impl="jax")[0]

        for layer in self.layers:
            x = checkpointed(body, layer, x)
        return x

    def _hybrid_stack_train(self, x: torch.Tensor, pos: torch.Tensor,
                            info: MaskInfo, remat: str,
                            mesh: Optional[DeviceMesh] = None
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The hybrid's segments: ``shared_attn_every`` Mamba2 layers then
        the shared decoder layer, each segment under the remat policy; the
        shared block's attention always takes the ``"heads"`` strategy
        (the reference's ``lm.py:167``)."""
        cfg = self.cfg
        k = cfg.shared_attn_every

        def segment(seg, h):
            for layer in seg:
                h = mamba2_layer(layer, h, cfg, impl="jax")[0]
            h, a, _ = decoder_layer_train(self.shared, h, pos, cfg,
                                          info.prefix_len, info.causal,
                                          impl="jax", mesh=mesh,
                                          strategy="heads")
            return h, a

        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for s in range(cfg.num_layers // k):
            x, a = remat_call(remat, segment, self.layers[s * k:(s + 1) * k],
                              x)
            aux = aux + a
        return x, aux

    def _pair_of(self, pair: str, what: str) -> None:
        """Raise unless this model's family takes ``pair`` of
        :data:`ENTRY_PAIRS`, naming the pair it takes."""
        if self.cfg.family not in ENTRY_PAIRS[pair]:
            other = next(p for p, fams in ENTRY_PAIRS.items()
                         if self.cfg.family in fams)
            raise NotImplementedError(
                f"{what} serves the {', '.join(ENTRY_PAIRS[pair])} "
                f"families; {self.cfg.family!r} runs through {other}")

    @torch.no_grad()
    def prefill(self, tokens: torch.Tensor,
                mesh: Optional[DeviceMesh] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """tokens (B, S) -> (last-position logits (B, V) fp32, k, v), k / v
        (L, B, S, KVH, D) post-RoPE.  A moe layer's FFN takes the path
        ``mesh`` gives it (``moe.moe_ffn``: all-to-all over ``model``,
        FSDP, or local); everything else runs whole on the model's device,
        the function GSPMD computes.  A moe layer's aux loss is dropped,
        as the reference's serving path drops it."""
        self._pair_of("prefill / decode_step", "prefill")
        cfg = self.cfg
        B, S = tokens.shape
        x = embed(self.embed, tokens, self.act_dtype)
        pos = torch.arange(S, device=tokens.device).expand(B, S)
        ks, vs = [], []
        for layer in self.layers:
            x, _, (k, v) = decoder_layer_train(layer, x, pos, cfg,
                                               mesh=mesh)
            ks.append(k)
            vs.append(v)
        xn = rms_norm(x[:, -1, :], self.final_norm, cfg.norm_eps)
        return self._logits(xn), torch.stack(ks), torch.stack(vs)

    @torch.no_grad()
    def decode_step(self, tokens: torch.Tensor, seq_lens: torch.Tensor,
                    k_pools, v_pools, block_table: torch.Tensor,
                    share_mask: torch.Tensor, base: torch.Tensor, *,
                    mesh: Optional[DeviceMesh] = None,
                    appends=None) -> torch.Tensor:
        """tokens (B,) just sampled, seq_lens (B,) the position of each
        (tokens already in the cache).  Appends every layer's K/V into
        ``k_pools`` / ``v_pools`` IN PLACE and returns the next-position
        logits (B, V) fp32.  The pools are (L, nblk, page, KVH, D) tensors,
        or under a ``mesh`` of more than one rank the per-rank slab lists
        (``RowCloneEngine.slabs("k")``, each (L, slab, page, KVH, D), in
        shard order); the block table, share mask (local columns when the
        batch shards, :func:`~repro_torch.models.paged
        .paged_attend_append`) and base address the GLOBAL block ids.
        ``appends``: the step's ``paged.rank_appends`` where the caller
        knows them (the dry-run's declared layout), else read from the
        block table (one host sync).  Everything but the paged attention
        runs whole on the model's device."""
        self._pair_of("prefill / decode_step", "decode_step")
        cfg, page = self.cfg, self.page
        ks = list(k_pools) if isinstance(k_pools, (list, tuple)) \
            else [k_pools]
        vs = list(v_pools) if isinstance(v_pools, (list, tuple)) \
            else [v_pools]
        pos = seq_lens.long()
        x = embed(self.embed, tokens, self.act_dtype)
        if appends is None:
            appends = rank_appends(*append_slots(pos, block_table, page),
                                   [s.shape[1] for s in ks])
        seq_incl = (pos + 1).to(torch.int32)
        for li, layer in enumerate(self.layers):
            x = decoder_layer_decode(layer, x, pos, [s[li] for s in ks],
                                     [s[li] for s in vs], appends,
                                     share_mask, base, seq_incl, cfg, page,
                                     mesh=mesh)
        xn = rms_norm(x, self.final_norm, cfg.norm_eps)
        return self._logits(xn)

    # ------------------------------------------------------------------
    # the facade pair over a serve state (vlm, ssm, hybrid, encdec)
    # ------------------------------------------------------------------
    def make_serve_state(self, batch: int, seq_len: int,
                         mesh: Optional[DeviceMesh] = None,
                         filled: Optional[int] = None,
                         dtype: Optional[torch.dtype] = None
                         ) -> Dict[str, torch.Tensor]:
        """Zero serve state with the identity block layout (the reference's
        ``make_serve_state``).  ``mesh``: the batch shards over its (pod,
        data) axes when their size divides ``batch`` (``dp``), and the
        share mask then has the ``batch // dp`` LOCAL columns of
        :func:`~repro_torch.models.paged.identity_layout`; under a mesh of
        more than one rank ``k_pools`` / ``v_pools`` are lists of per-rank
        slabs in shard order (``pool_shard_ranks``, as
        ``RowCloneEngine.slabs``), each (num_attn_layers, slab, page, KVH,
        D) on its rank's device with ``slab = ceil(nblk / ranks)`` (the
        last ones shorter); everything else stays whole on the model's
        device.  ``filled``: tokens already
        present per sequence (default ``seq_len - 1``).  Keys: ``seq_lens``;
        for vlm, hybrid and encdec ``block_table``, ``share_mask``, ``base``
        and ``k_pools`` / ``v_pools`` (num_attn_layers, nblk, page, KVH, D)
        in ``dtype`` (default the model dtype); for ssm and hybrid
        ``conv_state`` (L, B, W-1, C) and ``ssm_state`` (L, B, H, P, N)
        fp32, with the layer axis split (n_seg, shared_attn_every) for the
        hybrid; for encdec ``cross_k`` / ``cross_v`` (L, B, S_src, KVH, D)
        in ``dtype``, ``S_src = max(seq_len // src_frames_ratio, 1)`` (the
        reference's ``lm.py:248-253``)."""
        self._pair_of("prefill_state / decode_state", "make_serve_state")
        cfg, page = self.cfg, self.page
        dev = self.embed.device
        dtype = self.act_dtype if dtype is None else dtype
        filled = seq_len - 1 if filled is None else filled
        state = {"seq_lens": torch.full((batch,), filled, dtype=torch.int32,
                                        device=dev)}
        if cfg.num_attn_layers:
            state.update(paged_state(cfg, batch, seq_len, page, mesh, dtype,
                                     dev))
        if cfg.family == "encdec":
            S_src = max(seq_len // cfg.src_frames_ratio, 1)
            state["cross_k"] = torch.zeros(
                (cfg.num_layers, batch, S_src, cfg.num_kv_heads,
                 cfg.head_dim), dtype=dtype, device=dev)
            state["cross_v"] = torch.zeros_like(state["cross_k"])
        if cfg.family not in ("ssm", "hybrid"):
            return state
        lead = (cfg.num_layers,)
        if cfg.family == "hybrid":
            k = cfg.shared_attn_every
            lead = (cfg.num_layers // k, k)
        C = cfg.ssm_d_inner + 2 * cfg.ssm_state
        state["conv_state"] = torch.zeros(
            lead + (batch, cfg.ssm_conv_width - 1, C),
            dtype=torch.float32, device=dev)
        state["ssm_state"] = torch.zeros(
            lead + (batch, cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state),
            dtype=torch.float32, device=dev)
        return state

    def _per_layer(self, state: Dict[str, torch.Tensor]):
        """Views of the recurrent states with one leading layer axis (the
        hybrid's (n_seg, every) axes merged), and the number of Mamba2
        layers between shared-block calls (all of them for ssm)."""
        cfg = self.cfg
        L = cfg.num_layers
        conv, ssm = state["conv_state"], state["ssm_state"]
        every = cfg.shared_attn_every if cfg.family == "hybrid" else L
        return (conv.view((L,) + conv.shape[-3:]),
                ssm.view((L,) + ssm.shape[-4:]), every)

    @torch.no_grad()
    def prefill_state(self, tokens: torch.Tensor,
                      patch_embeds: Optional[torch.Tensor] = None,
                      margin_tokens: Optional[int] = None,
                      src_embeds: Optional[torch.Tensor] = None,
                      mesh: Optional[DeviceMesh] = None
                      ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Full forward over prompts of one length (no padding mask, as the
        reference); returns the last-position logits (B, V) fp32 and the
        serve state, with ``margin_tokens`` of decode capacity past the
        prompt (default one page).  vlm: ``patch_embeds`` (B,
        vision_tokens, d_model), required, go in front of the tokens'
        embeddings and are visible to every position (prefix-LM); the
        sequence is then ``vision_tokens + S`` long.  encdec:
        ``src_embeds`` (B, S_src, d_model), required, are the encoder's
        input frames (RoPE over positions 0..S_src-1, no causal mask, then
        ``enc_norm``); each decoder layer attends over them after its
        self-attention, and the state keeps each layer's cross K/V as
        ``cross_k`` / ``cross_v`` (L, B, S_src, KVH, D).  ``mesh``: the
        state is :meth:`make_serve_state`'s for that mesh (per-rank slabs,
        local mask columns when the batch shards); the forward runs whole
        on the model's device (the function GSPMD computes), and each page
        goes through the block table into the slab that holds its
        block."""
        self._pair_of("prefill_state / decode_state", "prefill_state")
        cfg, page = self.cfg, self.page
        for name, given, fam in (("patch_embeds", patch_embeds, "vlm"),
                                 ("src_embeds", src_embeds, "encdec")):
            if (given is None) == (cfg.family == fam):
                raise ValueError(f"{name}: required for the {fam} family, "
                                 f"refused for {cfg.family!r}")
        x = embed(self.embed, tokens, self.act_dtype)
        prefix = 0
        if patch_embeds is not None:
            x = torch.cat([patch_embeds.to(x.dtype), x], dim=1)
            prefix = patch_embeds.shape[1]
        B, S, _ = x.shape
        margin = page if margin_tokens is None else margin_tokens
        nper = (S + margin + page - 1) // page
        state = self.make_serve_state(B, nper * page, mesh=mesh, filled=S)
        if cfg.num_attn_layers:
            to_pools = _page_writer(state, page, nper)

        pos = torch.arange(S, device=tokens.device).expand(B, S)
        if cfg.family == "vlm":
            for li, layer in enumerate(self.layers):
                x, _, (k, v) = decoder_layer_train(layer, x, pos, cfg,
                                                   prefix_len=prefix)
                to_pools(li, k, v)
        elif cfg.family == "encdec":
            enc = self._encode(src_embeds.to(x.dtype))
            xks, xvs = [], []
            for li, layer in enumerate(self.layers):
                x, (k, v) = attn_block_train(layer, x, pos, cfg)
                x, (xk, xv) = cross_block_train(layer, x, enc, cfg)
                x, _ = layer.ffn(x, cfg)
                to_pools(li, k, v)
                xks.append(xk)
                xvs.append(xv)
            state["cross_k"] = torch.stack(xks)
            state["cross_v"] = torch.stack(xvs)
        else:
            conv, ssm, every = self._per_layer(state)
            for li, layer in enumerate(self.layers):
                x, ssm[li], conv[li] = mamba2_layer(layer, x, cfg)
                if cfg.family == "hybrid" and (li + 1) % every == 0:
                    x, _, (k, v) = decoder_layer_train(self.shared, x, pos,
                                                       cfg)
                    to_pools(li // every, k, v)
        xn = rms_norm(x[:, -1, :], self.final_norm, cfg.norm_eps)
        return self._logits(xn), state

    def _encode(self, src: torch.Tensor) -> torch.Tensor:
        """The encoder stack over frames src (B, S_src, d), then
        ``enc_norm``: RoPE over positions 0..S_src-1 and no causal mask
        (the reference's ``_backbone_train``, ``lm.py:130-139``)."""
        B, S_src, _ = src.shape
        pos = torch.arange(S_src, device=src.device).expand(B, S_src)
        for layer in self.enc_layers:
            src, _, _ = decoder_layer_train(layer, src, pos, self.cfg,
                                            causal=False)
        return rms_norm(src, self.enc_norm, self.cfg.norm_eps)

    @torch.no_grad()
    def decode_state(self, state: Dict[str, torch.Tensor],
                     tokens: torch.Tensor,
                     mesh: Optional[DeviceMesh] = None, *, appends=None
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """One token per sequence: ``tokens`` (B,) the token just sampled,
        at position ``state["seq_lens"]``.  Updates the state's pools and
        recurrent states IN PLACE (the reference returns new arrays) and
        returns the next-position logits (B, V) fp32 and the state with
        ``seq_lens`` advanced.  ``mesh``: the mesh the state was made for
        (its pools are per-rank slabs); each rank appends the tokens that
        land in its slab and runs K2 over it, and the partials are
        LSE-combined (``paged.paged_attend_append``); the rest runs whole
        on the model's device.  Refused, as the reference's ``shard_map``
        refuses it, when the ranks do not divide the block count.
        ``appends``: as :meth:`decode_step`'s."""
        self._pair_of("prefill_state / decode_state", "decode_state")
        cfg, page = self.cfg, self.page
        pos = state["seq_lens"].long()
        seq_incl = (pos + 1).to(torch.int32)
        if cfg.num_attn_layers:
            ks, vs = _slab_list(state["k_pools"]), _slab_list(state["v_pools"])
            _check_slabs(state, ks, tokens.shape[0], mesh)
            if appends is None:
                appends = rank_appends(*append_slots(
                    pos, state["block_table"], page),
                    [s.shape[1] for s in ks])

        def attend(layer: DecoderLayer, x: torch.Tensor,
                   i: int) -> torch.Tensor:
            cross = (state["cross_k"][i], state["cross_v"][i]) \
                if cfg.family == "encdec" else None
            return decoder_layer_decode(
                layer, x, pos, [s[i] for s in ks], [s[i] for s in vs],
                appends, state["share_mask"], state["base"], seq_incl, cfg,
                page, cross_kv=cross, mesh=mesh)

        x = embed(self.embed, tokens, self.act_dtype)
        if cfg.family in ("vlm", "encdec"):
            for li, layer in enumerate(self.layers):
                x = attend(layer, x, li)
        else:
            conv, ssm, every = self._per_layer(state)
            for li, layer in enumerate(self.layers):
                x, conv[li], ssm[li] = mamba2_decode_step(layer, x, conv[li],
                                                          ssm[li], cfg)
                if cfg.family == "hybrid" and (li + 1) % every == 0:
                    x = attend(self.shared, x, li // every)
        xn = rms_norm(x, self.final_norm, cfg.norm_eps)
        return self._logits(xn), dict(state, seq_lens=seq_incl)


def paged_state(cfg: ModelConfig, batch: int, seq_len: int, page: int,
                mesh: Optional[DeviceMesh], dtype: torch.dtype, device
                ) -> Dict[str, object]:
    """The paged half of a serve state (:meth:`LanguageModel
    .make_serve_state`'s ``block_table``, ``share_mask``, ``base``,
    ``k_pools``, ``v_pools``): the identity layout of ``batch`` sequences
    of ``seq_len`` slots, zero pools (num_attn_layers, nblk, page, KVH, D)
    on ``device``, or under a mesh of more than one rank one slab per
    rank in shard order, each on its rank's device."""
    table, mask, base = identity_layout(batch, seq_len, page,
                                        batch_shard_count(mesh, batch))
    state = {"block_table": torch.from_numpy(table).to(device),
             "share_mask": torch.from_numpy(mask).to(device),
             "base": torch.from_numpy(base).to(device)}
    nblk = base.shape[0]
    shape = (cfg.num_attn_layers, nblk, page, cfg.num_kv_heads, cfg.head_dim)
    if mesh is None or mesh.size == 1:
        state["k_pools"] = torch.zeros(shape, dtype=dtype, device=device)
        state["v_pools"] = torch.zeros_like(state["k_pools"])
        return state
    ranks = pool_shard_ranks(mesh)
    ss = -(-nblk // len(ranks))
    for name in ("k_pools", "v_pools"):
        state[name] = [on_rank(torch.zeros(
            (shape[0], min(ss, max(nblk - i * ss, 0))) + shape[2:],
            dtype=dtype, device=mesh.devices[r]), r)
            for i, r in enumerate(ranks)]
    return state


def _slab_list(pools) -> list:
    """A state's K or V pools as a slab list (one whole pool: one slab)."""
    return list(pools) if isinstance(pools, (list, tuple)) else [pools]


def _check_slabs(state: Dict[str, torch.Tensor], ks: list, batch: int,
                 mesh: Optional[DeviceMesh]) -> None:
    """Refuse a state that ``mesh`` cannot decode: slabs of another mesh,
    local mask columns without a mesh, or (the reference's ``shard_map``
    condition) a block count the pool shards do not divide."""
    cols, nblk = state["share_mask"].shape[1], state["base"].shape[0]
    n = 1 if mesh is None else pool_shard_count(mesh)
    if n == 1 or mesh.size == 1:
        if len(ks) != 1 or cols != batch:
            raise ValueError(
                f"a state of {len(ks)} slabs and {cols} mask columns for "
                f"{batch} sequences needs the mesh it was made for: "
                "decode_state(state, tokens, mesh=)")
        return
    if len(ks) != n:
        raise ValueError(f"a state of {len(ks)} slabs for a mesh of {n} "
                         "pool shards: make it with make_serve_state(mesh=) "
                         "or prefill_state(mesh=) of this mesh")
    if nblk % n:
        raise ValueError(f"{nblk} blocks do not divide over {n} pool "
                         "shards (the reference's shard_map refuses them)")


def _page_writer(state: Dict[str, torch.Tensor], page: int, nper: int):
    """``to_pools(i, k, v)``: write attention layer i's K / V (B, S, KVH,
    D) of a prefill into the state's pools.  The state has
    :meth:`LanguageModel.make_serve_state`'s identity layout, where
    sequence b's blocks are pool rows ``b * nper`` to ``b * nper + nper -
    1``: a whole pool takes K / V in place through a view; slab r of a
    slab list takes the pages of its own rows (zero past S), copied to
    its rank's device."""
    ks, vs = _slab_list(state["k_pools"]), _slab_list(state["v_pools"])

    def to_pools(i: int, k: torch.Tensor, v: torch.Tensor) -> None:
        for kv, slabs in ((k, ks), (v, vs)):
            if len(slabs) == 1:
                B, S = kv.shape[:2]
                slabs[0][i].view((B, nper * page) +
                                 tuple(kv.shape[2:]))[:, :S] = kv
                continue
            pages = kv_to_pools(kv[None], page, slabs[0].dtype, nper)[0]
            start = 0
            for slab in slabs:
                slab[i].copy_(pages[start:start + slab.shape[1]])
                start += slab.shape[1]

    return to_pools


def append_slots(pos: torch.Tensor, block_table: torch.Tensor, page: int
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Where each sequence's token at ``pos`` (B,) lands: the batch slots
    that hold a sequence (an empty slot's table row is -1) and their block
    ids and in-block offsets."""
    ids = torch.gather(block_table.long(), 1, (pos // page)[:, None])[:, 0]
    rows = (ids >= 0).nonzero()[:, 0]
    return rows, ids[rows], (pos % page)[rows]


def kv_to_pools(kv: torch.Tensor, page: int, dtype: torch.dtype,
                nper: int) -> torch.Tensor:
    """(L, B, S, KVH, D) -> (L, B * nper, page, KVH, D): the contiguous
    layout with ``nper`` blocks per sequence, zero-padded past S (the
    paged attention's validity check masks the padding)."""
    L, B, S, KVH, D = kv.shape
    cap = nper * page
    if S < cap:
        kv = torch.nn.functional.pad(kv, (0, 0, 0, 0, 0, cap - S))
    return kv.reshape(L, B * nper, page, KVH, D).to(dtype)


__all__ = ["ENTRY_PAIRS", "LanguageModel", "PORTED_FAMILIES", "append_slots",
           "kv_to_pools", "model_dtype", "paged_state"]
