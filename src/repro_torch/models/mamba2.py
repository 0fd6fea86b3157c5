"""Mamba2 / SSD blocks (port of ``repro/models/mamba2.py``): the chunked
prefill path and the O(1) one-token decode step.

Prefill and training use the SSD block decomposition (arXiv:2405.21060
§6): the intra-chunk quadratic term is K4 for prefill
(``ops.ssd_intra_chunk``, one launch per layer with the chunks folded into
the batch axis) and the model-level :func:`ssd_intra_chunk` for training
(``impl="jax"``, as the reference trains), and the inter-chunk state
recurrence is a plain loop over chunks, as the reference's ``lax.scan`` is
jnp.  Every decay is ``exp`` of a within-chunk cumsum
difference <= 0.  Decode carries ``(conv_state, ssm_state)`` in fp32.

Dtypes follow the reference: the projections run in the activation dtype,
the conv in fp32, ``dt`` and ``A`` in fp32; ``ssd_chunked`` returns ``y``
in ``x.dtype`` and the final state in fp32.  Weights keep the JAX layout
``(in, out)``.

A layer whose weights ``weights.place_params`` placed (or a training
step's placed bf16 views) runs through :func:`mamba2_layer_placed`
(prefill, and training with ``impl="jax"``) and
:func:`mamba2_decode_step_placed`
on a :class:`~repro_torch.launch.mesh.Sharded` residual split by batch, as
the reference's GSPMD computes over its constraints (``proj`` over
``act_ffn``, ``xs`` over ``act_heads``): ``w_in`` column-parallel over its
blocks at rest, whose columns straddle ``z | xBC | dt``, so each rank's
``z`` and ``dt`` (by heads) and pre-conv ``xBC`` (by ``conv_ch``) are
joined from the product blocks that hold their columns; the conv by
channel block; each rank's heads through the SSD (K4) over its batch
block's whole sequence, with ``B`` and ``C`` (the last ``2N`` channels,
on the last ``model`` ranks after the conv) gathered onto it;
``gate_norm`` over all ``d_inner`` channels from the blocks' fp32 sums of
squares; ``w_out`` row-parallel.  The moves count to the op-cost walk's
paths :data:`PLACED_PATHS`.
"""
from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.configs import ModelConfig
from repro_torch.launch.mesh import (Sharded, Sharding, map_blocks,
                                     rank_scope, take)
from repro_torch.models.common import (blockwise, col_parallel, rms_norm,
                                       rms_norm_placed, row_parallel)
from repro_torch.sharding.rules import logical_to_spec


def _param(shape, dtype, device) -> nn.Parameter:
    return nn.Parameter(torch.zeros(shape, dtype=dtype, device=device),
                        requires_grad=False)


class Mamba2Layer(nn.Module):
    """One Mamba2 layer's weights.  ``w_in`` / ``w_out`` are in the model
    dtype (the reference casts its fp32 weights to the activation dtype at
    use); the conv, ``dt_bias``, ``A_log``, ``D`` and the norm gains stay
    fp32."""

    def __init__(self, cfg: ModelConfig, dtype: torch.dtype, device):
        super().__init__()
        d, di = cfg.d_model, cfg.ssm_d_inner
        H, N, W = cfg.ssm_heads, cfg.ssm_state, cfg.ssm_conv_width
        conv_ch = di + 2 * N
        f32 = torch.float32
        self.norm = _param((d,), f32, device)
        # in_proj -> [z (di), xBC (di + 2N), dt (H)]
        self.w_in = _param((d, 2 * di + 2 * N + H), dtype, device)
        self.conv_w = _param((W, conv_ch), f32, device)
        self.conv_b = _param((conv_ch,), f32, device)
        self.dt_bias = _param((H,), f32, device)
        self.A_log = _param((H,), f32, device)
        self.D = _param((H,), f32, device)
        self.gate_norm = _param((di,), f32, device)
        self.w_out = _param((di, d), dtype, device)


# ---------------------------------------------------------------------------
# SSD chunked scan (prefill and training)
# ---------------------------------------------------------------------------

#: the intra-chunk term each ``impl`` runs (the reference's names):
#: ``"pallas"`` K4, ``"jax"`` the model-level :func:`ssd_intra_chunk`
SSD_IMPLS = ("pallas", "jax")


def ssd_intra_chunk(xb, dtb, cum, Bb, Cb):
    """The SSD intra-chunk quadratic term (the reference's
    ``_ssd_intra_chunk_jnp``, K4's plain version).

    xb (B, Q, H, P); dtb, cum (B, Q, H), ``cum`` the inclusive cumsum of
    ``dt * A`` within the chunk; Bb, Cb (B, Q, N).  Returns (B, Q, H, P)
    fp32: ``y_i = sum_{j <= i} (C_i . B_j) exp(cum_i - cum_j) dt_j x_j``.
    The decay is selected, never multiplied, above the diagonal, where
    ``cum_i - cum_j > 0`` may overflow."""
    Q = xb.shape[1]
    scores = Cb.float() @ Bb.float().transpose(1, 2)             # (B,Qi,Qj)
    seg = cum.float()[:, :, None, :] - cum.float()[:, None, :, :]
    mask = torch.ones((Q, Q), dtype=torch.bool, device=xb.device).tril()
    L = torch.where(mask[None, :, :, None], torch.exp(seg),
                    torch.zeros_like(seg))                       # (B,Qi,Qj,H)
    W = scores[..., None] * L * dtb.float()[:, None, :, :]
    return torch.einsum("bijh,bjhp->bihp", W, xb.float())


def ssd_chunked(x, dt, A, B_mat, C_mat, D_skip, chunk: int,
                impl: str = "pallas") -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B,S,H,P); dt (B,S,H) > 0 fp32; A (H,) < 0; B_mat / C_mat (B,S,N);
    D_skip (H,).  Returns y (B,S,H,P) in ``x.dtype`` and the final state
    (B,H,P,N) fp32.  S is padded to a chunk multiple only when S > chunk
    (``dt = 0`` on the padding is a no-op); a shorter S is one ragged
    chunk.  ``impl`` (:data:`SSD_IMPLS`) chooses the intra-chunk term:
    K4 (prefill) or the model-level function (training); either takes
    every chunk of every sequence in one call."""
    if impl == "pallas":
        from repro_torch.kernels import ops as kops
        intra_fn = kops.ssd_intra_chunk
    elif impl == "jax":
        intra_fn = ssd_intra_chunk
    else:
        raise ValueError(f"impl {impl!r}: one of {SSD_IMPLS}")
    Bb, S, H, P = x.shape
    N = B_mat.shape[-1]
    S_orig = S
    if S % chunk and S > chunk:
        pad = chunk - S % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B_mat = F.pad(B_mat, (0, 0, 0, pad))
        C_mat = F.pad(C_mat, (0, 0, 0, pad))
        S += pad
    nc = max(S // chunk, 1)
    Q = S // nc

    xc = x.reshape(Bb * nc, Q, H, P)
    dtc = dt.float().reshape(Bb * nc, Q, H)
    Bc = B_mat.reshape(Bb * nc, Q, N)
    Cc = C_mat.reshape(Bb * nc, Q, N)
    cum = torch.cumsum(dtc * A[None, None, :], dim=1)            # inclusive
    # the intra-chunk term does not depend on the carried state: one call
    # for every chunk of every sequence
    y_intra = intra_fn(xc.contiguous(), dtc.contiguous(), cum.contiguous(),
                       Bc.contiguous(), Cc.contiguous())
    y_intra = y_intra.reshape(Bb, nc, Q, H, P)
    cum = cum.reshape(Bb, nc, Q, H)
    xf = x.float().reshape(Bb, nc, Q, H, P)
    dtf = dtc.reshape(Bb, nc, Q, H)
    Bf = B_mat.float().reshape(Bb, nc, Q, N)
    Cf = C_mat.float().reshape(Bb, nc, Q, N)

    h = torch.zeros((Bb, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for c in range(nc):
        cum_c = cum[:, c]
        # contribution of the carried state
        y_inter = torch.einsum("bqn,bhpn->bqhp", Cf[:, c], h) * \
            torch.exp(cum_c)[..., None]
        ys.append(y_intra[:, c] + y_inter)
        # state update
        w = torch.exp(cum_c[:, -1:, :] - cum_c) * dtf[:, c]      # (B,Q,H)
        S_c = torch.einsum("bqhp,bqn->bhpn", xf[:, c] * w[..., None],
                           Bf[:, c])
        h = h * torch.exp(cum_c[:, -1, :])[:, :, None, None] + S_c
    y = torch.stack(ys, 1).reshape(Bb, S, H, P)
    y = y + x.float() * D_skip[None, None, :, None]
    return y[:, :S_orig].to(x.dtype), h


# ---------------------------------------------------------------------------
# causal depthwise conv
# ---------------------------------------------------------------------------

def causal_conv1d(x, w, b):
    """x (B,S,C); w (W,C); b (C,).  Causal depthwise conv + silu, in fp32
    whatever the activation dtype: W shifted multiply-adds (the reference's
    ``lax.conv`` is XLA's, not a Pallas kernel)."""
    W, S = w.shape[0], x.shape[1]
    pad = F.pad(x.float(), (0, 0, W - 1, 0))
    wf = w.float()
    out = pad[:, 0:S] * wf[0]
    for k in range(1, W):
        out = out + pad[:, k:k + S] * wf[k]
    return F.silu(out + b.float())


def conv_step(conv_state, x_new, w, b):
    """One decode step.  conv_state (B,W-1,C); x_new (B,C).  Returns the
    activation (B,C) and the shifted state."""
    window = torch.cat([conv_state, x_new[:, None, :]], dim=1)   # (B,W,C)
    y = torch.einsum("bwc,wc->bc", window, w) + b[None, :]
    return F.silu(y), window[:, 1:, :]


# ---------------------------------------------------------------------------
# full layer: prefill + decode
# ---------------------------------------------------------------------------

def _split_proj(proj, cfg: ModelConfig):
    di, N = cfg.ssm_d_inner, cfg.ssm_state
    return proj[..., :di], proj[..., di:2 * di + 2 * N], \
        proj[..., 2 * di + 2 * N:]


def mamba2_layer(layer: Mamba2Layer, x, cfg: ModelConfig,
                 impl: str = "pallas"):
    """Full-sequence forward (prefill with K4, training with
    ``impl="jax"``).  x (B,S,d_model).  Returns (x + out, h_final
    (B,H,P,N) fp32, conv_tail (B,W-1,C) fp32) so prefill can seed decode."""
    B, S, _ = x.shape
    di, N, H, P = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    h = rms_norm(x, layer.norm, cfg.norm_eps)
    proj = h @ layer.w_in.to(h.dtype)
    z, xBC, dt_raw = _split_proj(proj, cfg)
    xBC = causal_conv1d(xBC, layer.conv_w, layer.conv_b).to(h.dtype)
    xs = xBC[..., :di].reshape(B, S, H, P)
    B_mat = xBC[..., di:di + N]
    C_mat = xBC[..., di + N:]
    dt = F.softplus(dt_raw.float() + layer.dt_bias[None, None, :])
    A = -torch.exp(layer.A_log.float())
    y, h_final = ssd_chunked(xs, dt, A, B_mat, C_mat, layer.D.float(),
                             cfg.ssm_chunk, impl)
    y = y.reshape(B, S, di)
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), layer.gate_norm,
                 cfg.norm_eps)
    out = y @ layer.w_out.to(y.dtype)
    return x + out, h_final, xbc_tail(layer, x, cfg)


def xbc_tail(layer: Mamba2Layer, x, cfg: ModelConfig):
    """Recompute the last W-1 pre-conv activations from the layer INPUT, in
    fp32, to seed decode."""
    W = cfg.ssm_conv_width
    h = rms_norm(x[:, -(W - 1):, :], layer.norm, cfg.norm_eps)
    _, xBC, _ = _split_proj(h @ layer.w_in.to(h.dtype), cfg)
    return xBC.float()


def mamba2_decode_step(layer: Mamba2Layer, x, conv_state, ssm_state,
                       cfg: ModelConfig):
    """One-token decode.  x (B,d_model); conv_state (B,W-1,di+2N) and
    ssm_state (B,H,P,N) fp32.  Returns (y, conv_state', ssm_state'); the
    step runs in fp32 and casts before ``w_out``."""
    B, _ = x.shape
    di, N, H, P = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads, \
        cfg.ssm_head_dim
    h = rms_norm(x, layer.norm, cfg.norm_eps)
    z, xBC_new, dt_raw = _split_proj(h @ layer.w_in.to(h.dtype), cfg)
    xBC, conv_state = conv_step(conv_state, xBC_new.float(),
                                layer.conv_w.float(), layer.conv_b.float())
    xt = xBC[..., :di].reshape(B, H, P)
    B_t = xBC[..., di:di + N]
    C_t = xBC[..., di + N:]
    dt = F.softplus(dt_raw.float() + layer.dt_bias[None, :])
    A = -torch.exp(layer.A_log.float())
    decay = torch.exp(dt * A[None, :])                           # (B,H)
    dbx = (xt * dt[..., None])[..., None] * B_t[:, None, None, :]
    ssm_state = ssm_state * decay[..., None, None] + dbx
    y = torch.einsum("bhpn,bn->bhp", ssm_state, C_t)
    y = y + xt * layer.D.float()[None, :, None]
    y = rms_norm(y.reshape(B, di) * F.silu(z.float()), layer.gate_norm,
                 cfg.norm_eps)
    out = y.to(x.dtype) @ layer.w_out.to(x.dtype)
    return x + out, conv_state, ssm_state


# ---------------------------------------------------------------------------
# a placed layer (weights.place_params): each rank computes its blocks
# ---------------------------------------------------------------------------

#: the op-cost walk's path of each move of the placed layer: the joins of
#: the ``w_in`` product's columns into each rank's ``z`` / ``xBC`` / ``dt``
#: and of the conv's channels into its heads, the ``B`` / ``C`` gathers and
#: the gate norm's sums of squares (the ``w_out`` partial sums are
#: ``"sum"``, ``common.row_parallel``'s)
PLACED_PATHS = {"columns": "ssm_columns", "bc": "ssm_bc",
                "gate": "gate_norm"}


def ssm_layouts(mesh, B: int, S: int, cfg: ModelConfig
                ) -> Tuple[Sharding, Sharding]:
    """The layouts of a placed layer's activations over (B, S, ...): by
    heads (``("batch", None, "act_heads")``: ``z``, ``dt``, ``xs`` and
    ``y``, ``d_inner`` split as the heads) and by conv channel
    (``("batch", None, "act_ffn")``: the conv's ``xBC``), each resolved
    on its dims (a dim its axes do not divide stays whole)."""
    H, C = cfg.ssm_heads, cfg.ssm_d_inner + 2 * cfg.ssm_state
    return tuple(Sharding(mesh, logical_to_spec(("batch", None, ax), mesh,
                                                dims=(B, S, n)))
                 for ax, n in (("act_heads", H), ("act_ffn", C)))


def _placed_in(layer: Mamba2Layer, x: Sharded, cfg: ModelConfig):
    """norm(x) @ ``w_in`` column-parallel over ``w_in``'s blocks at rest,
    and each rank's pieces joined from the product blocks that hold their
    columns: ``z`` (B, S, d_inner) and ``dt_raw`` (B, S, H) by heads, the
    pre-conv ``xBC`` (B, S, C) by conv channel."""
    B, S, _ = x.shape
    di, N, H = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_heads
    h = rms_norm_placed(x, layer.norm, cfg.norm_eps)
    proj, = col_parallel(h, (layer.w_in, None))
    hsh, csh = ssm_layouts(x.sharding.mesh, B, S, cfg)

    def cols(c0):
        return lambda b, sl, r: take(
            proj, r, (sl[0], sl[1], slice(c0 + sl[2].start,
                                          c0 + sl[2].stop)),
            path=PLACED_PATHS["columns"])

    return (map_blocks(hsh, (B, S, di), cols(0)),
            map_blocks(csh, (B, S, di + 2 * N), cols(di)),
            map_blocks(hsh, (B, S, H), cols(2 * di + 2 * N)))


def _heads_of(layer: Mamba2Layer, xc: Sharded, dt_raw: torch.Tensor,
              r: int, rows: slice, heads: slice, cfg: ModelConfig):
    """On rank ``r``, for its batch block ``rows`` and head block
    ``heads``: its ``xs`` channels joined from the conv's channel blocks,
    ``B`` and ``C`` gathered, ``dt`` (softplus with its ``dt_bias``), ``A``
    and ``D`` of its heads."""
    di, N, P = cfg.ssm_d_inner, cfg.ssm_state, cfg.ssm_head_dim
    mesh = xc.sharding.mesh

    def chans(c0, c1, path):
        return take(xc, r, (rows, slice(None), slice(c0, c1)), path=path)

    xs = chans(heads.start * P, heads.stop * P, PLACED_PATHS["columns"])
    Bm = chans(di, di + N, PLACED_PATHS["bc"])
    Cm = chans(di + N, di + 2 * N, PLACED_PATHS["bc"])
    par = [take(getattr(layer, n), r, (heads,), mesh=mesh).float()
           for n in ("dt_bias", "A_log", "D")]
    dt = F.softplus(dt_raw.float() + par[0])
    return xs, Bm, Cm, dt, -torch.exp(par[1]), par[2]


def gate_norm_placed(layer: Mamba2Layer, gated: Sharded, ssq: Sharded,
               cfg: ModelConfig, dtype: torch.dtype) -> Sharded:
    """``rms_norm`` over all ``d_inner`` channels of ``gated`` (laid out by
    heads): each block's fp32 sums of squares ``ssq`` (one column a head
    block) gathered onto every rank of its batch block and added there,
    each block then scaled by the mean and its ``gate_norm`` slice.
    Returns the blocks in ``dtype``."""
    di, eps = cfg.ssm_d_inner, cfg.norm_eps
    mesh = gated.sharding.mesh

    def one(b, sl, r):
        total = take(ssq, r, (sl[0],), path=PLACED_PATHS["gate"]).sum(
            -1, keepdim=True)
        y = gated.blocks[b].float() * torch.rsqrt(total / di + eps)
        scale = take(layer.gate_norm, r, (sl[2],), mesh=mesh).float()
        return (y * (1.0 + scale)).to(dtype)

    return map_blocks(gated.sharding, gated.shape, one)


def _by_heads(hsh: Sharding, B: int, S: int, fn, cfg: ModelConfig):
    """``fn(b, rows, heads, r)`` -> (gated block, state block) on each head
    block's owner; returns gated (B, S, d_inner) laid out by ``hsh``, its
    sums of squares (B, S, head blocks) and the states (B, H, P, N) laid
    out by (batch, heads)."""
    di, H, P, N = cfg.ssm_d_inner, cfg.ssm_heads, cfg.ssm_head_dim, \
        cfg.ssm_state
    nh = hsh.counts(3)[2]
    per = H // nh
    gated, ssq, states = {}, {}, {}
    for b, r in hsh.owners().items():
        rows = hsh.slices(b, (B, S, di))[0]
        heads = slice(b[2] * per, (b[2] + 1) * per)
        with rank_scope(r):
            gated[b], states[(b[0], b[2])] = fn(b, rows, heads, r)
            ssq[b] = gated[b].float().square().sum(-1, keepdim=True)
    ssh = Sharding(hsh.mesh, (hsh.spec[0], hsh.spec[2]))
    return (Sharded(hsh, (B, S, di), gated), Sharded(hsh, (B, S, nh), ssq),
            Sharded(ssh, (B, H, P, N), states))


def mamba2_layer_placed(layer: Mamba2Layer, x: Sharded, cfg: ModelConfig,
                        impl: str = "pallas"
                        ) -> Tuple[Sharded, Sharded, Sharded]:
    """:func:`mamba2_layer` of a placed layer: x (B, S, d) Sharded by batch
    (the reference's ``("batch", None, None)``; any layout works).  Each
    rank runs the SSD over its batch block's whole sequence and its heads,
    its intra-chunk term by ``impl`` (:data:`SSD_IMPLS`): K4 once a rank
    and layer in prefill, the model-level function in training (a
    training step's placed views, under autograd).  Returns the new x
    (laid out as x), the final state (B, H, P, N) fp32 laid out by
    (batch, ``act_heads``) and the conv tail (B, W-1, C) fp32 by (batch,
    None, ``act_ffn``), the last W-1 pre-conv rows of each channel block
    (the reference recomputes them from the layer's input: the same
    product)."""
    B, S, _ = x.shape
    W = cfg.ssm_conv_width
    mesh = x.sharding.mesh
    z, xbc, dt_raw = _placed_in(layer, x, cfg)
    dtype = x.dtype
    xc = map_blocks(xbc.sharding, xbc.shape, lambda b, sl, r: causal_conv1d(
        xbc.blocks[b], take(layer.conv_w, r, (slice(None), sl[2]),
                            mesh=mesh),
        take(layer.conv_b, r, (sl[2],), mesh=mesh)).to(dtype))
    hsh = z.sharding

    def ssd(b, rows, heads, r):
        xs, Bm, Cm, dt, A, D = _heads_of(layer, xc, dt_raw.blocks[b], r,
                                         rows, heads, cfg)
        Bg, nh = xs.shape[0], heads.stop - heads.start
        y, h_final = ssd_chunked(xs.reshape(Bg, S, nh, cfg.ssm_head_dim),
                                 dt, A, Bm, Cm, D, cfg.ssm_chunk, impl)
        y = y.reshape(Bg, S, -1)
        return y * F.silu(z.blocks[b].float()).to(y.dtype), h_final

    gated, ssq, h_final = _by_heads(hsh, B, S, ssd, cfg)
    y = gate_norm_placed(layer, gated, ssq, cfg, dtype)
    x = blockwise(torch.add, x, row_parallel(y, layer.w_out, x.sharding))
    tail = map_blocks(xbc.sharding, (B, W - 1, xbc.shape[2]),
                      lambda b, sl, r: xbc.blocks[b][:, S - (W - 1):].float())
    return x, h_final, tail


def mamba2_decode_step_placed(layer: Mamba2Layer, x: Sharded,
                              conv_state: Sharded, ssm_state: Sharded,
                              cfg: ModelConfig) -> Sharded:
    """:func:`mamba2_decode_step` of a placed layer: x (B, 1, d) Sharded by
    batch; ``conv_state`` (B, W-1, C) and ``ssm_state`` (B, H, P, N) this
    layer's state leaves, laid out by the serve state's axes (batch and
    ``act_ffn`` / ``act_heads``), updated IN PLACE by channel and head
    block.  Returns the new x, laid out as x."""
    B = x.shape[0]
    mesh = x.sharding.mesh
    z, xbc, dt_raw = _placed_in(layer, x, cfg)

    def conv(b, sl, r):
        cs = conv_state.blocks[conv_state.sharding.block_of(r)]
        y, new = conv_step(cs, xbc.blocks[b][:, 0].float(), take(
            layer.conv_w, r, (slice(None), sl[2]), mesh=mesh).float(),
            take(layer.conv_b, r, (sl[2],), mesh=mesh).float())
        cs.copy_(new)
        return y[:, None]

    xc = map_blocks(xbc.sharding, xbc.shape, conv)

    def step(b, rows, heads, r):
        xt, Bt, Ct, dt, A, D = _heads_of(layer, xc, dt_raw.blocks[b][:, 0],
                                         r, rows, heads, cfg)
        Bg, nh = xt.shape[0], heads.stop - heads.start
        xt = xt[:, 0].reshape(Bg, nh, cfg.ssm_head_dim)
        Bt, Ct = Bt[:, 0], Ct[:, 0]
        st = ssm_state.blocks[ssm_state.sharding.block_of(r)]
        decay = torch.exp(dt * A[None, :])
        dbx = (xt * dt[..., None])[..., None] * Bt[:, None, None, :]
        st.copy_(st * decay[..., None, None] + dbx)
        y = torch.einsum("bhpn,bn->bhp", st, Ct) + xt * D[None, :, None]
        return y.reshape(Bg, 1, -1) * F.silu(z.blocks[b].float()), st

    gated, ssq, _ = _by_heads(z.sharding, B, 1, step, cfg)
    y = gate_norm_placed(layer, gated, ssq, cfg, x.dtype)
    return blockwise(torch.add, x, row_parallel(y, layer.w_out, x.sharding))


__all__ = ["Mamba2Layer", "PLACED_PATHS", "SSD_IMPLS", "ssd_intra_chunk",
           "ssd_chunked", "causal_conv1d", "conv_step", "mamba2_layer",
           "gate_norm_placed", "mamba2_layer_placed", "mamba2_decode_step",
           "mamba2_decode_step_placed", "ssm_layouts", "xbc_tail"]
