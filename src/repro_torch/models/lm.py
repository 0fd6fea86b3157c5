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
autograd, no kernel and the stacks checkpointed; over a mesh of more than
one rank every block of the loss, and of its backward, runs on the rank
that holds it (:meth:`LanguageModel._loss_placed`, on the placed bf16
views a training step sets on the modules).  The serving pairs run under
``torch.no_grad``.

A model whose weights ``weights.place_params`` placed over a mesh
(every serving family, :data:`PLACED_FAMILIES`;
:attr:`LanguageModel.placement`) serves over that mesh, each rank
computing its blocks: a dense or moe model through ``prefill(mesh=)`` /
``decode_step(mesh=)``, a moe layer's experts where they lie
(``models/transformer.py``, ``models/moe.py moe_ffn_placed``); a vlm,
ssm, hybrid or encdec model through ``prefill_state(mesh=)`` /
``decode_state(mesh=)``, its Mamba2 layers by batch and head blocks
(``models/mamba2.py mamba2_layer_placed``), its encoder and
cross-attention by blocks, and its serve state's recurrent and cross
leaves placed by :meth:`LanguageModel.state_logical_axes`.  The training
loss refuses a model placed for serving.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from repro_torch.configs import (DECODER_FAMILIES, ModelConfig,
                                 RowCloneConfig)
from repro_torch.launch.mesh import (DeviceMesh, Sharded, Sharding,
                                     map_blocks, on_rank, pool_shard_count,
                                     pool_shard_ranks, rank_scope,
                                     sharding_for, take, zeros)
from repro_torch.models.attention import MaskInfo
from repro_torch.models.common import (checkpointed, chunked_softmax_xent,
                                       chunked_softmax_xent_placed, embed,
                                       embed_placed, logits_placed, rms_norm,
                                       rms_norm_placed)
from repro_torch.models.mamba2 import (Mamba2Layer, mamba2_decode_step,
                                       mamba2_decode_step_placed,
                                       mamba2_layer, mamba2_layer_placed)
from repro_torch.models.paged import (batch_shard_count, identity_layout,
                                     rank_appends)
from repro_torch.models.transformer import (DecoderLayer, attn_block_train,
                                            cross_block_train,
                                            decoder_layer_decode,
                                            decoder_layer_decode_placed,
                                            decoder_layer_placed,
                                            decoder_layer_train,
                                            decoder_layer_train_placed,
                                            decoder_stack_train,
                                            decoder_stack_train_placed,
                                            remat_call)
from repro_torch.sharding.rules import attn_strategy, logical_to_spec

#: the families each entry pair takes: the engine's pair (``prefill`` /
#: ``decode_step``) and the facade's (``prefill_state`` / ``decode_state``
#: / ``make_serve_state``)
ENTRY_PAIRS = {"prefill / decode_step": DECODER_FAMILIES,
               "prefill_state / decode_state": ("vlm", "ssm", "hybrid",
                                                "encdec")}
PORTED_FAMILIES = tuple(f for fams in ENTRY_PAIRS.values() for f in fams)

#: the families whose placed weights serve (``weights.place_params``):
#: every one
PLACED_FAMILIES = PORTED_FAMILIES

#: the reference's logical axes of each serve-state leaf
#: (``lm.py:256-276``); ``conv_state`` / ``ssm_state`` past their layer
#: axes (one for ssm, the hybrid's two), which lead with ``None``s
STATE_AXES = {
    "seq_lens": ("batch",), "block_table": ("batch", None),
    "share_mask": ("kv_blocks", None), "base": ("kv_blocks",),
    "k_pools": ("layers", "kv_blocks", None, None, None),
    "v_pools": ("layers", "kv_blocks", None, None, None),
    "conv_state": ("batch", None, "act_ffn"),
    "ssm_state": ("batch", "act_heads", None, None),
    "cross_k": (None, "batch", None, None, None),
    "cross_v": (None, "batch", None, None, None),
}


class Placement(NamedTuple):
    """Where :func:`repro_torch.weights.place_params` put a model's
    weights: the mesh, and each parameter's placed value by its
    ``named_parameters`` name."""

    mesh: DeviceMesh
    values: Dict[str, object]


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
        #: the :class:`Placement` of the weights, None while whole
        self.placement: Optional[Placement] = None
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

    @property
    def device(self) -> torch.device:
        """The device the model serves from: its weights', or a placed
        model's first rank's."""
        if self.placement is not None:
            return self.placement.mesh.devices[0]
        return self.embed.device

    def check_placed(self, mesh: Optional[DeviceMesh]) -> bool:
        """Whether a serving call over ``mesh`` runs the placed path: False
        for unplaced weights; raise for a placed model over another mesh
        than its placement's."""
        if self.placement is None:
            return False
        if mesh != self.placement.mesh:
            raise ValueError(f"a model placed over a mesh of shape "
                             f"{self.placement.mesh.shape} runs over that "
                             f"mesh (mesh=), not {mesh}")
        return True

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        """The head is a bf16 product whatever the config dtype (as
        ``lm.py:94-98`` of the reference); logits come back fp32."""
        w = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        return (x.to(torch.bfloat16) @ w.to(torch.bfloat16)).float()

    # ------------------------------------------------------------------
    # training forward (full sequence; the reference's _backbone_train)
    # ------------------------------------------------------------------
    def forward(self, batch: Dict[str, object],
                remat: str = "minimal", mesh: Optional[DeviceMesh] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The module's forward is the training loss (:meth:`loss_fn`)."""
        return self.loss_fn(batch, remat, mesh)

    def loss_fn(self, batch: Dict[str, torch.Tensor],
                remat: str = "minimal", mesh: Optional[DeviceMesh] = None
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The training loss of a ``data.make_batch`` batch: ``tokens`` /
        ``labels`` / ``mask`` (B, S), a vlm's ``patch_embeds`` and an
        encdec's ``src_embeds``.  Returns (total, {"loss", "aux"}): the
        masked mean cross-entropy with its z-loss
        (``common.chunked_softmax_xent``), the moe layers' aux losses
        summed (0 for the other families), ``total = loss + 1e-2 aux``.
        ``remat`` names the decoder stack's policy
        (``transformer.REMAT_POLICIES``).  Without a mesh (or over one
        rank) everything runs on this model's device.  Over a ``mesh`` of
        more than one rank every block runs on the rank that holds it
        (:meth:`_loss_placed`), reading the weights the modules hold: a
        training step sets its placed bf16 views on them for the call
        (``launch/train.py``); the batch may be placed or whole.
        Differentiable; no kernel runs (the training attention and SSD
        term are model-level functions)."""
        cfg = self.cfg
        if self.placement is not None:
            raise ValueError("loss_fn: placed weights (weights.place_params) "
                             "serve only; train the unplaced model")
        if mesh is not None and mesh.size > 1:
            return self._loss_placed(batch, remat, mesh)
        x, aux, prefix = self._backbone_train(batch, remat)
        x = rms_norm(x, self.final_norm, cfg.norm_eps)
        if prefix:
            x = x[:, prefix:, :]
        w = self.embed.T if cfg.tie_embeddings else self.lm_head
        loss = chunked_softmax_xent(x, w, batch["labels"], batch["mask"])
        total = loss + 1e-2 * aux
        return total, {"loss": loss, "aux": aux}

    def _backbone_train(self, batch: Dict[str, torch.Tensor], remat: str
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
                                         remat=remat)
            return x, aux, prefix
        if cfg.family == "ssm":
            return self._mamba_stack_train(x), zero, 0
        if cfg.family == "hybrid":
            x, aux = self._hybrid_stack_train(x, pos, info, remat)
            return x, aux, 0
        # encdec: the encoder over the source frames, then the decoder
        # with cross-attention
        enc = batch["src_embeds"].to(x.dtype)
        B_e, S_src, _ = enc.shape
        pos_e = torch.arange(S_src, device=x.device).expand(B_e, S_src)
        enc, _ = decoder_stack_train(self.enc_layers, enc, pos_e, cfg,
                                     MaskInfo(causal=False), remat=remat)
        enc = rms_norm(enc, self.enc_norm, cfg.norm_eps)
        x, aux = decoder_stack_train(self.layers, x, pos, cfg, info,
                                     enc_out=enc, remat=remat)
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
                            info: MaskInfo, remat: str
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
                                          impl="jax")
            return h, a

        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for s in range(cfg.num_layers // k):
            x, a = remat_call(remat, segment, self.layers[s * k:(s + 1) * k],
                              x)
            aux = aux + a
        return x, aux

    def _loss_placed(self, batch: Dict[str, object], remat: str,
                     mesh: DeviceMesh
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """:meth:`loss_fn` over ``mesh``, every block on the rank that
        holds it, as the reference's GSPMD computes its step: the residual
        laid out by ``("batch", "act_seq_tp", None)`` for a decoder stack
        and by ``("batch", None, None)`` for a Mamba2 stack (each rank's
        SSD needs its batch block's whole sequence), a dim the axes do not
        divide whole; the embedding by ``common.embed_placed`` (the vlm's
        patches in front, by batch block); decoder and encoder stacks by
        ``transformer.decoder_stack_train_placed`` (an encdec's encoder
        non-causal, then ``enc_norm`` by blocks, its decoder with the
        cross blocks); a Mamba2 layer by ``mamba2.mamba2_layer_placed``
        with the model-level SSD term, each layer checkpointed (ssm) or
        each hybrid segment under ``remat`` with the shared block's
        ``"heads"`` attention; the final norm by blocks; the loss by
        ``common.chunked_softmax_xent_placed``.  The loss, the aux loss and
        the total lie on the mesh's first rank."""
        cfg = self.cfg
        x, pos, prefix = self._embed_placed(batch["tokens"],
                                            batch.get("patch_embeds"), mesh)
        info = MaskInfo(causal=True, prefix_len=prefix)
        with rank_scope(0):
            aux = torch.zeros((), dtype=torch.float32,
                              device=mesh.devices[0])
        if cfg.family == "ssm":
            def body(layer, h):
                return mamba2_layer_placed(layer, h, cfg, impl="jax")[0]

            for layer in self.layers:
                x = checkpointed(body, layer, x)
        elif cfg.family == "hybrid":
            every = cfg.shared_attn_every

            def segment(seg, h):
                for layer in seg:
                    h = mamba2_layer_placed(layer, h, cfg, impl="jax")[0]
                return decoder_layer_train_placed(self.shared, h, pos, cfg,
                                                  "heads", info)

            for s in range(cfg.num_layers // every):
                x, a = remat_call(remat, segment,
                                  self.layers[s * every:(s + 1) * every], x)
                with rank_scope(0):
                    aux = aux + a
        else:
            enc = None
            if cfg.family == "encdec":
                enc = self._encode_placed(batch["src_embeds"], mesh,
                                          remat=remat)
            x, aux = decoder_stack_train_placed(self.layers, x, pos, cfg,
                                                info, enc_out=enc,
                                                remat=remat)
        xn = rms_norm_placed(x, self.final_norm, cfg.norm_eps)
        head = self.embed if cfg.tie_embeddings else self.lm_head
        loss = chunked_softmax_xent_placed(xn, head, cfg.tie_embeddings,
                                           batch["labels"], batch["mask"],
                                           offset=prefix)
        with rank_scope(0):
            total = loss + 1e-2 * aux
        return total, {"loss": loss, "aux": aux}

    def _embed_placed(self, tokens, patch_embeds, mesh: DeviceMesh):
        """The residual of a placed forward over the full sequence: the
        tokens' (B, S) embeddings by ``common.embed_placed``, a vlm's
        ``patch_embeds`` (placed or whole) in front of them by batch
        block, laid out by ``("batch", None, None)`` for a Mamba2 stack
        (each rank's SSD needs its batch block's whole sequence) and by
        ``("batch", "act_seq_tp", None)`` for a decoder stack, a dim the
        axes do not divide whole.  Returns (x, the positions (B, S) laid
        out as x's first two dims, the prefix's length)."""
        cfg = self.cfg
        B, S_text = tokens.shape
        prefix = 0 if patch_embeds is None else patch_embeds.shape[1]
        S, d = prefix + S_text, cfg.d_model
        mamba = cfg.family in ("ssm", "hybrid")
        xs = Sharding(mesh, logical_to_spec(
            ("batch", None if mamba else "act_seq_tp", None), mesh,
            dims=(B, S, d)))
        if prefix:
            text = embed_placed(self.embed, tokens, self.act_dtype,
                                Sharding(mesh, xs.spec[:1]))
            x = map_blocks(xs, (B, S, d), lambda b, sl, r: _prefixed(
                patch_embeds, text, r, sl, prefix, mesh))
        else:
            x = embed_placed(self.embed, tokens, self.act_dtype, xs)
        return x, _positions(xs, B, S), prefix

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
        as the reference's serving path drops it.  A placed dense or moe
        model computes each rank's blocks over its placement's ``mesh`` and
        returns k / v as one (L, B_g, S, KVH, D) stack per batch group, on
        the group's first rank (:meth:`_prefill_placed`)."""
        self._pair_of("prefill / decode_step", "prefill")
        if self.check_placed(mesh):
            return self._prefill_placed(tokens, mesh)
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
        runs whole on the model's device, but for a placed dense or moe
        model, whose ranks compute their blocks (its placement's
        ``mesh``)."""
        self._pair_of("prefill / decode_step", "decode_step")
        placed = self.check_placed(mesh)
        cfg, page = self.cfg, self.page
        ks = list(k_pools) if isinstance(k_pools, (list, tuple)) \
            else [k_pools]
        vs = list(v_pools) if isinstance(v_pools, (list, tuple)) \
            else [v_pools]
        pos = seq_lens.long()
        if appends is None:
            appends = rank_appends(*append_slots(pos, block_table, page),
                                   [s.shape[1] for s in ks])
        seq_incl = (pos + 1).to(torch.int32)
        if placed:
            B = tokens.shape[0]
            xs = Sharding(mesh, logical_to_spec(
                ("batch", None, None), mesh, dims=(B, 1, cfg.d_model)))
            x = embed_placed(self.embed, tokens[:, None], self.act_dtype, xs)
            for li, layer in enumerate(self.layers):
                x = decoder_layer_decode_placed(
                    layer, x, pos, [s[li] for s in ks], [s[li] for s in vs],
                    appends, share_mask, base, seq_incl, cfg, page, mesh)
            return self._logits_placed(x)
        x = embed(self.embed, tokens, self.act_dtype)
        for li, layer in enumerate(self.layers):
            x = decoder_layer_decode(layer, x, pos, [s[li] for s in ks],
                                     [s[li] for s in vs], appends,
                                     share_mask, base, seq_incl, cfg, page,
                                     mesh=mesh)
        xn = rms_norm(x, self.final_norm, cfg.norm_eps)
        return self._logits(xn)

    def _prefill_placed(self, tokens: torch.Tensor, mesh: DeviceMesh):
        """:meth:`prefill` of a placed model: the residual Sharded by
        ``("batch", "act_seq_tp", None)`` (a dim the axes do not divide
        stays whole), each layer :func:`~repro_torch.models.transformer
        .decoder_layer_placed` by ``attn_strategy``, the logits by
        vocabulary slices joined on the mesh's first rank.  Returns
        (logits (B, V) fp32, k, v): k / v lists with one (L, B_g, S, KVH,
        D) stack a batch group, on the group's first rank."""
        cfg = self.cfg
        B, S = tokens.shape
        L, KVH, D = cfg.num_layers, cfg.num_kv_heads, cfg.head_dim
        xs = Sharding(mesh, logical_to_spec(("batch", "act_seq_tp", None),
                                            mesh, dims=(B, S, cfg.d_model)))
        x = embed_placed(self.embed, tokens, self.act_dtype, xs)
        pos = _positions(xs, B, S)
        strategy = attn_strategy(cfg.num_heads, mesh)
        # each batch group's first rank, in group order, and its stacks
        homes = list(Sharding(mesh, xs.spec[:1]).owners().values())
        Bg = B // len(homes)
        ks, vs = [], []
        for r in homes:
            with rank_scope(r):
                for out in (ks, vs):
                    out.append(torch.empty((L, Bg, S, KVH, D),
                                           dtype=self.act_dtype,
                                           device=mesh.devices[r]))
        for li, layer in enumerate(self.layers):
            x, k, v, _ = decoder_layer_placed(layer, x, pos, cfg, strategy)
            for g, r in enumerate(homes):
                rows = slice(g * Bg, (g + 1) * Bg)
                for stack, t in ((ks[g], k), (vs[g], v)):
                    with rank_scope(r):
                        stack[li].copy_(take(t, r, (rows,)).reshape(
                            Bg, S, KVH, D))
        return self._logits_placed(_last_row(x)), ks, vs

    def _logits_placed(self, x) -> torch.Tensor:
        """The final norm and the logits of a placed model's x (B, 1, d),
        joined (B, V) fp32 on the mesh's first rank."""
        cfg = self.cfg
        xn = rms_norm_placed(x, self.final_norm, cfg.norm_eps)
        head = self.embed if cfg.tie_embeddings else self.lm_head
        return logits_placed(xn, head, cfg.tie_embeddings)

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
        reference's ``lm.py:248-253``).  A placed model (over its
        placement's ``mesh``) holds ``conv_state``, ``ssm_state``,
        ``cross_k`` and ``cross_v`` as :class:`~repro_torch.launch.mesh
        .Sharded` zeros placed by :meth:`state_logical_axes` (each block
        made on its owner); the pools are the slabs as above, and the
        layout leaves (``seq_lens``, the table, mask and base, which the
        host reads) stay whole on the first rank."""
        self._pair_of("prefill_state / decode_state", "make_serve_state")
        placed = self.check_placed(mesh)
        cfg, page = self.cfg, self.page
        dev = self.device
        dtype = self.act_dtype if dtype is None else dtype
        filled = seq_len - 1 if filled is None else filled

        def new(key, shape, dt):
            if not placed:
                return torch.zeros(shape, dtype=dt, device=dev)
            return zeros(sharding_for(mesh, shape, _leaf_axes(key, len(shape))),
                         shape, dt)

        state = {"seq_lens": torch.full((batch,), filled, dtype=torch.int32,
                                        device=dev)}
        if cfg.num_attn_layers:
            state.update(paged_state(cfg, batch, seq_len, page, mesh, dtype,
                                     dev))
        if cfg.family == "encdec":
            S_src = max(seq_len // cfg.src_frames_ratio, 1)
            for key in ("cross_k", "cross_v"):
                state[key] = new(key, (cfg.num_layers, batch, S_src,
                                       cfg.num_kv_heads, cfg.head_dim), dtype)
        if cfg.family not in ("ssm", "hybrid"):
            return state
        lead = (cfg.num_layers,)
        if cfg.family == "hybrid":
            k = cfg.shared_attn_every
            lead = (cfg.num_layers // k, k)
        C = cfg.ssm_d_inner + 2 * cfg.ssm_state
        state["conv_state"] = new(
            "conv_state", lead + (batch, cfg.ssm_conv_width - 1, C),
            torch.float32)
        state["ssm_state"] = new(
            "ssm_state", lead + (batch, cfg.ssm_heads, cfg.ssm_head_dim,
                                 cfg.ssm_state), torch.float32)
        return state

    def state_logical_axes(self, state: Dict[str, object]
                           ) -> Dict[str, Tuple[Optional[str], ...]]:
        """The reference's logical axes of each leaf of a serve state
        (``lm.py:256-276``, :data:`STATE_AXES`): the recurrent states'
        lead with a ``None`` for each layer axis (two for the hybrid's
        (n_seg, every))."""
        return {key: _leaf_axes(key, _ndim(v)) for key, v in state.items()
                if key in STATE_AXES}

    def _per_layer(self, state: Dict[str, torch.Tensor]):
        """Views of the recurrent states with one leading layer axis (the
        hybrid's (n_seg, every) axes merged), and the number of Mamba2
        layers between shared-block calls (all of them for ssm).  A placed
        state's leaves give, for each layer, a :class:`~repro_torch.launch
        .mesh.Sharded` of views into their blocks."""
        cfg = self.cfg
        L = cfg.num_layers
        conv, ssm = state["conv_state"], state["ssm_state"]
        every = cfg.shared_attn_every if cfg.family == "hybrid" else L
        if isinstance(conv, Sharded):
            return (_LayerViews(conv, 3), _LayerViews(ssm, 4), every)
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
        goes through the block table into the slab that holds its block.
        A placed model computes each rank's blocks over its placement's
        ``mesh`` (:meth:`_prefill_state_placed`)."""
        self._pair_of("prefill_state / decode_state", "prefill_state")
        placed = self.check_placed(mesh)
        cfg, page = self.cfg, self.page
        for name, given, fam in (("patch_embeds", patch_embeds, "vlm"),
                                 ("src_embeds", src_embeds, "encdec")):
            if (given is None) == (cfg.family == fam):
                raise ValueError(f"{name}: required for the {fam} family, "
                                 f"refused for {cfg.family!r}")
        if placed:
            return self._prefill_state_placed(tokens, patch_embeds,
                                              margin_tokens, src_embeds, mesh)
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

    def _prefill_state_placed(self, tokens: torch.Tensor,
                              patch_embeds: Optional[torch.Tensor],
                              margin_tokens: Optional[int],
                              src_embeds: Optional[torch.Tensor],
                              mesh: DeviceMesh
                              ) -> Tuple[torch.Tensor, Dict[str, object]]:
        """:meth:`prefill_state` of a placed model.  The residual is
        Sharded by ``("batch", None, None)`` for a Mamba2 stack (the
        reference's ``_embed``: each rank's SSD needs its batch block's
        whole sequence) and by ``("batch", "act_seq_tp", None)`` for a
        decoder stack (the vlm's patches in front, prefix-LM; an encdec's
        encoder over its frames, non-causal), a dim the axes do not divide
        whole.  Mamba2 layers by :func:`~repro_torch.models.mamba2
        .mamba2_layer_placed`, decoder layers (the hybrid's shared block
        with ``"heads"``, the reference's ``lm.py:167``) by
        :func:`~repro_torch.models.transformer.decoder_layer_placed`; each
        page of K/V is taken onto the rank of the slab that holds its
        block, the recurrent and cross states' blocks onto their owners.
        Returns the logits (B, V) fp32, joined on the first rank, and the
        state."""
        cfg, page = self.cfg, self.page
        B = tokens.shape[0]
        x, pos, prefix = self._embed_placed(tokens, patch_embeds, mesh)
        S = x.shape[1]
        margin = page if margin_tokens is None else margin_tokens
        nper = (S + margin + page - 1) // page
        state = self.make_serve_state(B, nper * page, mesh=mesh, filled=S)
        mamba = cfg.family in ("ssm", "hybrid")
        if cfg.num_attn_layers:
            to_pools = _placed_page_writer(state, page, nper, mesh)
        if mamba:
            conv, ssm, every = self._per_layer(state)
            for li, layer in enumerate(self.layers):
                x, h_final, tail = mamba2_layer_placed(layer, x, cfg)
                _store(ssm[li], h_final)
                _store(conv[li], tail)
                if cfg.family == "hybrid" and (li + 1) % every == 0:
                    x, k, v, _ = decoder_layer_placed(self.shared, x, pos,
                                                      cfg, "heads")
                    to_pools(li // every, k, v)
            return self._logits_placed(_last_row(x)), state
        strategy = attn_strategy(cfg.num_heads, mesh)
        enc = None
        if cfg.family == "encdec":
            enc = self._encode_placed(src_embeds, mesh, strategy)
            # the cross state holds the frames given (as the reference's
            # prefill, whatever make_serve_state's S_src)
            shape = (cfg.num_layers, B, enc.shape[1], cfg.num_kv_heads,
                     cfg.head_dim)
            for key in ("cross_k", "cross_v"):
                state[key] = zeros(sharding_for(mesh, shape, STATE_AXES[key]),
                                   shape, state[key].dtype)
        for li, layer in enumerate(self.layers):
            x, k, v, xkv = decoder_layer_placed(
                layer, x, pos, cfg, strategy, prefix_len=prefix,
                enc_out=enc)
            to_pools(li, k, v)
            if xkv is not None:
                for key, t in zip(("cross_k", "cross_v"), xkv):
                    _store(_LayerViews(state[key], 4)[li], t)
        return self._logits_placed(_last_row(x)), state

    def _encode_placed(self, src, mesh: DeviceMesh,
                       strategy: Optional[str] = None,
                       remat: Optional[str] = None) -> Sharded:
        """:meth:`_encode` of a placed model: the frames src (B, S_src, d),
        placed or whole, laid out by ``("batch", "act_seq_tp", None)``,
        each encoder layer by blocks without the causal mask (prefill;
        with ``remat``, the training stack under that policy), then
        ``enc_norm`` block by block."""
        B, S_src, d = src.shape
        xe = Sharding(mesh, logical_to_spec(("batch", "act_seq_tp", None),
                                            mesh, dims=(B, S_src, d)))
        x = map_blocks(xe, (B, S_src, d), lambda b, sl, r: take(
            src, r, sl[:2], mesh=mesh).to(self.act_dtype))
        pos = _positions(xe, B, S_src)
        if remat is not None:
            x, _ = decoder_stack_train_placed(
                self.enc_layers, x, pos, self.cfg, MaskInfo(causal=False),
                remat=remat)
        else:
            for layer in self.enc_layers:
                x, _, _, _ = decoder_layer_placed(layer, x, pos, self.cfg,
                                                  strategy, causal=False)
        return rms_norm_placed(x, self.enc_norm, self.cfg.norm_eps)

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
        on the model's device, but for a placed model, whose ranks compute
        their blocks and update their blocks of the recurrent states in
        place (the state :meth:`prefill_state` or :meth:`make_serve_state`
        made over its placement's ``mesh``).  Refused, as the reference's
        ``shard_map`` refuses it, when the ranks do not divide the block
        count.  ``appends``: as :meth:`decode_step`'s."""
        self._pair_of("prefill_state / decode_state", "decode_state")
        placed = self.check_placed(mesh)
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

        def attend(layer: DecoderLayer, x, i: int):
            if cfg.family != "encdec":
                cross = None
            elif placed:
                cross = tuple(_LayerViews(state[k], 4)[i]
                              for k in ("cross_k", "cross_v"))
            else:
                cross = (state["cross_k"][i], state["cross_v"][i])
            args = (layer, x, pos, [s[i] for s in ks], [s[i] for s in vs],
                    appends, state["share_mask"], state["base"], seq_incl,
                    cfg, page)
            if placed:
                return decoder_layer_decode_placed(*args, mesh,
                                                   cross_kv=cross)
            return decoder_layer_decode(*args, cross_kv=cross, mesh=mesh)

        if placed:
            B = tokens.shape[0]
            x = embed_placed(self.embed, tokens[:, None], self.act_dtype,
                             Sharding(mesh, logical_to_spec(
                                 ("batch", None, None), mesh,
                                 dims=(B, 1, cfg.d_model))))
            step = mamba2_decode_step_placed
        else:
            x = embed(self.embed, tokens, self.act_dtype)
            step = mamba2_decode_step
        if cfg.family in ("vlm", "encdec"):
            for li, layer in enumerate(self.layers):
                x = attend(layer, x, li)
        else:
            conv, ssm, every = self._per_layer(state)
            for li, layer in enumerate(self.layers):
                if placed:
                    x = step(layer, x, conv[li], ssm[li], cfg)
                else:
                    x, conv[li], ssm[li] = step(layer, x, conv[li], ssm[li],
                                                cfg)
                if cfg.family == "hybrid" and (li + 1) % every == 0:
                    x = attend(self.shared, x, li // every)
        if placed:
            return self._logits_placed(x), dict(state, seq_lens=seq_incl)
        xn = rms_norm(x, self.final_norm, cfg.norm_eps)
        return self._logits(xn), dict(state, seq_lens=seq_incl)


def build_model(cfg: ModelConfig, device="cuda",
                rc: RowCloneConfig = RowCloneConfig(),
                param_dtype: Optional[torch.dtype] = None) -> LanguageModel:
    """The model of ``cfg`` on ``device`` with every weight zero (the
    reference's ``build_model``, which builds the module and no weights):
    :func:`repro_torch.weights.init_params` (random weights from a seed)
    and :func:`repro_torch.weights.from_jax_params` (the reference's)
    build it filled."""
    return LanguageModel(cfg, device, rc, param_dtype=param_dtype)


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


def _leaf_axes(key: str, ndim: int) -> Tuple[Optional[str], ...]:
    """:data:`STATE_AXES` of leaf ``key``, led by a ``None`` for each layer
    axis of a recurrent state of ``ndim`` dims."""
    ax = STATE_AXES[key]
    return (None,) * (ndim - len(ax)) + ax


def _ndim(v) -> int:
    """Dims of a state leaf: a tensor, a Sharded or a slab list."""
    return v[0].ndim if isinstance(v, (list, tuple)) else v.ndim


class _LayerViews:
    """Layer i of a placed state leaf with ``tail`` dims past its layer
    axes: ``views[i]`` is a :class:`~repro_torch.launch.mesh.Sharded` over
    the leaf's shape past those axes whose blocks are views into the
    leaf's blocks (a write into them writes the state)."""

    def __init__(self, leaf: Sharded, tail: int):
        self.leaf, self.lead = leaf, leaf.ndim - tail

    def __getitem__(self, i: int) -> Sharded:
        leaf, lead = self.leaf, self.lead
        return Sharded(
            Sharding(leaf.sharding.mesh, leaf.sharding.spec[lead:]),
            leaf.shape[lead:],
            {b[lead:]: t.view((-1,) + t.shape[lead:])[i]
             for b, t in leaf.blocks.items()})


def _store(dst: Sharded, src) -> None:
    """Copy ``src`` (a Sharded or tensor of ``dst``'s shape, or of its
    elements with its whole trailing dims merged) into ``dst``'s blocks,
    each taken onto its owner."""
    owners = dst.sharding.owners()
    for b, blk in dst.blocks.items():
        r = owners[b]
        sl = tuple(s if n == dst.shape[i] else slice(None) for i, (s, n) in
                   enumerate(zip(dst.sharding.slices(b, dst.shape),
                                 src.shape)))
        with rank_scope(r):
            blk.copy_(take(src, r, sl, mesh=dst.sharding.mesh)
                      .reshape(blk.shape))


def _positions(xs: Sharding, B: int, S: int) -> Sharded:
    """The positions (B, S) laid out as the first two dims of ``xs``."""
    mesh = xs.mesh
    return map_blocks(Sharding(mesh, xs.spec[:2]), (B, S), lambda b, sl, r:
                      torch.arange(*sl[1].indices(S)[:2],
                                   device=mesh.devices[r]).expand(
                          sl[0].stop - sl[0].start, -1))


def _last_row(x: Sharded) -> Sharded:
    """The last position of a placed residual (B, S, d), (B, 1, d) by its
    batch blocks."""
    B, S, d = x.shape
    return map_blocks(Sharding(x.sharding.mesh, (x.sharding.spec[0], None,
                                                 None)),
                      (B, 1, d), lambda b, sl, r: take(
                          x, r, (sl[0], slice(S - 1, S))))


def _prefixed(patches: torch.Tensor, text: Sharded, r: int, sl, prefix: int,
              mesh: DeviceMesh) -> torch.Tensor:
    """The block ``sl`` of the vlm's sequence on rank ``r``: its rows of the
    patch embeddings (whole on the first rank) in front of its rows of
    the text's embeddings."""
    rows, seq = sl[0], sl[1]
    s0, s1 = seq.start, seq.stop
    parts = []
    if s0 < prefix:
        parts.append(take(patches, r, (rows, slice(s0, min(s1, prefix))),
                          mesh=mesh).to(text.dtype))
    if s1 > prefix:
        parts.append(take(text, r, (rows, slice(max(s0, prefix) - prefix,
                                                s1 - prefix))))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def _placed_page_writer(state: Dict[str, object], page: int, nper: int,
                        mesh: DeviceMesh):
    """``to_pools(i, k, v)``: write a placed prefill's layer-i K / V (B, S,
    KVH * D), Sharded, into the state's slabs (the identity layout of
    :func:`_page_writer`): each slab's pages taken from the blocks that
    hold their rows onto the slab's rank (path ``"pages"``); pages past S
    stay zero."""
    ks, vs = _slab_list(state["k_pools"]), _slab_list(state["v_pools"])
    ranks = pool_shard_ranks(mesh)

    def to_pools(i: int, k: Sharded, v: Sharded) -> None:
        S = k.shape[1]
        for kv, slabs in ((k, ks), (v, vs)):
            start = 0
            for slab, r in zip(slabs, ranks):
                n = slab.shape[1]
                flat = slab[i].view((n * page,) + tuple(slab.shape[3:]))
                for b in range(start // nper, -(-(start + n) // nper)):
                    r0, r1 = max(start, b * nper), min(start + n,
                                                       (b + 1) * nper)
                    p0, p1 = (r0 - b * nper) * page, \
                        min((r1 - b * nper) * page, S)
                    if p1 <= p0:
                        continue
                    at = (r0 - start) * page
                    with rank_scope(r):
                        flat[at:at + p1 - p0].copy_(take(
                            kv, r, (slice(b, b + 1), slice(p0, p1)),
                            path="pages").reshape((p1 - p0,) +
                                                  flat.shape[1:]))
                start += n

    return to_pools


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


__all__ = ["ENTRY_PAIRS", "LanguageModel", "PLACED_FAMILIES",
           "PORTED_FAMILIES", "Placement", "STATE_AXES", "append_slots",
           "build_model", "kv_to_pools", "model_dtype", "paged_state"]
