"""Weights of the port's models (dense, moe, vlm, ssm, hybrid, encdec).

* :func:`init_params` makes random weights on the target device from a
  seeded ``torch.Generator``, with the scales of the reference's
  initialisers (``repro/models/common.py``, ``repro/models/mamba2.py``):
  embedding and untied head N(0, 0.02), dense N(0, 1/in), norm gains and
  QKV biases zero; a moe FFN's router N(0, 0.02), expert ``w_gate`` /
  ``w_up`` N(0, 1/d) and ``w_down`` N(0, 1/f), shared experts as a dense
  MLP (``repro/models/moe.py``); a vlm's tree is the dense one's, its head
  tied to the embedding; an encdec's encoder layers are dense decoder
  layers, its decoder layers' cross-attention ``xattn`` is drawn as a
  self-attention's projections, ``enc_norm`` and ``ln_x`` are zero;
  Mamba2 ``conv_w`` N(0, 1/W), ``dt_bias = log(expm1(dt))`` with ``dt``
  log-uniform in [1e-3, 1e-1], ``A_log = log(1..H)``, ``D = 1``.  Nothing
  is downloaded.
* :func:`from_jax_params` loads the JAX parameter tree (after
  ``split_params``, every leaf converted to numpy; layer weights stacked on
  a leading axis, the hybrid's ``shared`` decoder layer unstacked, an
  encdec's ``enc_layers`` stacked and ``enc_norm``) into the port's
  modules, for the parity tests; :func:`jax_path` is the correspondence
  of names it loads through.
* :func:`param_axes` gives each parameter the reference's logical axes
  (``split_params``'s axes tree, without the stacked ``"layers"`` entry,
  which resolves to no mesh axis under either rule set): what the
  training state is placed by over a mesh (``launch/train.py``), and the
  serving weights by :func:`place_params`.
* :func:`place_params` places a model's serving weights over a mesh as
  the reference's dry-run places its bf16 weights (``p_sh16 =
  tree_shardings(mesh, params_bf16, axes)``): each parameter split by its
  logical axes under the active rules (``DEFAULT_RULES``: ``embed`` over
  ``data``, ``qkv`` / ``heads`` / ``ffn`` / ``vocab`` / ``experts`` over
  ``model``, a rule whose axes do not divide the dim leaving it whole, so
  that a moe FFN's ``ffn`` takes ``model`` where its experts do not
  divide it), each block on its rank's device and the model's own
  tensors released.

Serving holds the matrices in the model dtype; training holds every
parameter in fp32 (``param_dtype=torch.float32``), the reference's master
weights.

The JAX layout ``(in, out)`` is kept.
"""
from __future__ import annotations

import math
from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import ModelConfig, RowCloneConfig
from repro_torch.launch.mesh import DeviceMesh, place, sharding_for
from repro_torch.models.lm import LanguageModel, Placement, build_model
from repro_torch.models.mamba2 import Mamba2Layer
from repro_torch.models.transformer import DecoderLayer

#: range of the Mamba2 timestep at init (``mamba2.py:31-32``)
DT_MIN, DT_MAX = 1e-3, 1e-1


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a GPU
    raises (entry points run on the card unless asked for the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "plain versions on the CPU")
    return device


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda",
                rc: RowCloneConfig = RowCloneConfig(),
                param_dtype: Optional[torch.dtype] = None) -> LanguageModel:
    """Random weights made on ``device`` from ``torch.Generator(seed)``;
    ``param_dtype=torch.float32`` makes every parameter fp32 (training's
    master weights), by default the matrices are in the model dtype."""
    device = resolve_device(device)
    model = build_model(cfg, device, rc, param_dtype=param_dtype)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def normal_(p: torch.nn.Parameter, scale: float) -> None:
        # draw in fp32 then round, one weight at a time (bounded scratch)
        w = torch.randn(p.shape, generator=gen, device=device,
                        dtype=torch.float32)
        p.data.copy_(w.mul_(scale))

    def mlp(m, f: int) -> None:
        normal_(m.w_gate, cfg.d_model ** -0.5)
        normal_(m.w_up, cfg.d_model ** -0.5)
        normal_(m.w_down, f ** -0.5)

    def attn(m) -> None:
        for name in ("wq", "wk", "wv"):
            normal_(getattr(m, name), cfg.d_model ** -0.5)
        normal_(m.wo, cfg.q_dim ** -0.5)

    def decoder(layer: DecoderLayer) -> None:
        attn(layer)
        if hasattr(layer, "xattn"):
            attn(layer.xattn)
        if cfg.family != "moe":
            mlp(layer, cfg.d_ff)
            return
        moe = layer.moe
        normal_(moe.router, 0.02)
        mlp(moe, cfg.moe_d_ff or cfg.d_ff)
        if moe.shared is not None:
            mlp(moe.shared, moe.shared.w_down.shape[0])

    def mamba(layer: Mamba2Layer) -> None:
        H = cfg.ssm_heads
        normal_(layer.w_in, cfg.d_model ** -0.5)
        normal_(layer.conv_w, cfg.ssm_conv_width ** -0.5)
        u = torch.rand((H,), generator=gen, device=device)
        dt = torch.exp(math.log(DT_MIN) + u * (math.log(DT_MAX) -
                                               math.log(DT_MIN)))
        layer.dt_bias.data.copy_(torch.log(torch.expm1(dt)))
        layer.A_log.data.copy_(torch.log(torch.arange(
            1, H + 1, dtype=torch.float32, device=device)))
        layer.D.data.fill_(1.0)
        normal_(layer.w_out, cfg.ssm_d_inner ** -0.5)

    normal_(model.embed, 0.02)
    if not cfg.tie_embeddings:
        normal_(model.lm_head, 0.02)
    for layer in model.layers:
        (decoder if isinstance(layer, DecoderLayer) else mamba)(layer)
    if cfg.family == "hybrid":
        decoder(model.shared)
    for layer in getattr(model, "enc_layers", ()):
        decoder(layer)
    return model


def _to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


#: a SwiGLU's parameters (the dense MLP, the experts, the shared experts)
SWIGLU_PARAMS = ("w_gate", "w_up", "w_down")

#: the Mamba2 layer's parameters, by their name in the JAX tree
MAMBA2_PARAMS = ("norm", "w_in", "conv_w", "conv_b", "dt_bias", "A_log", "D",
                 "gate_norm", "w_out")


#: the attention projections and biases, held under ``attn`` in the JAX
#: tree and directly on the port's decoder layer
_ATTN_PARAMS = ("wq", "wk", "wv", "wo", "bq", "bk", "bv")


def jax_path(name: str) -> Tuple[Tuple[str, ...], Optional[int]]:
    """The JAX tree's path of the port's parameter ``name`` (as
    ``named_parameters`` gives it) and its index on the tree's stacked
    layer axis (None for an unstacked leaf): ``layers.3.wq`` is
    ``("layers", "attn", "wq")`` at 3, a dense layer's ``w_up`` sits under
    ``mlp``, the hybrid's ``shared.*`` is unstacked; every other name maps
    one to one (``layers.0.moe.shared.w_gate``, ``layers.1.xattn.wk``, a
    Mamba2 layer's ``A_log``, ``enc_layers.0.ln1``, ``final_norm``).
    :func:`from_jax_params` loads through it and the optimizer's decay
    mask reads the reference's path names through it."""
    parts = name.split(".")
    if parts[0] in ("layers", "enc_layers"):
        top, idx, rest = parts[0], int(parts[1]), parts[2:]
    elif parts[0] == "shared":
        top, idx, rest = parts[0], None, parts[1:]
    else:
        return tuple(parts), None
    if rest[0] in _ATTN_PARAMS:
        rest = ["attn"] + rest
    elif rest[0] in SWIGLU_PARAMS:
        rest = ["mlp"] + rest
    return (top, *rest), idx


#: the reference's logical axes of each parameter, by its leaf name
#: (``repro/models/common.py``, ``transformer.py``, ``mamba2.py``,
#: ``lm.py`` initialisers); a moe FFN's expert weights and router by
#: :data:`_MOE_AXES`
_LEAF_AXES = {
    "embed": ("vocab", "embed"), "lm_head": ("embed", "vocab"),
    "final_norm": ("norm",), "enc_norm": ("norm",), "ln1": ("norm",),
    "ln2": ("norm",), "ln_x": ("norm",),
    "wq": ("embed", "qkv"), "wk": ("embed", "qkv"), "wv": ("embed", "qkv"),
    "wo": ("qkv", "embed"), "bq": ("qkv",), "bk": ("qkv",), "bv": ("qkv",),
    "w_gate": ("embed", "ffn"), "w_up": ("embed", "ffn"),
    "w_down": ("ffn", "embed"),
    "norm": ("norm",), "w_in": ("embed", "ssm_inner"),
    "conv_w": ("conv_w", "conv_ch"), "conv_b": ("conv_ch",),
    "dt_bias": ("ssm_heads_p",), "A_log": ("ssm_heads_p",),
    "D": ("ssm_heads_p",), "gate_norm": ("ssm_inner",),
    "w_out": ("ssm_inner", "embed"),
}
_MOE_AXES = {"router": ("embed", "experts"),
             "w_gate": ("experts", "embed", "ffn"),
             "w_up": ("experts", "embed", "ffn"),
             "w_down": ("experts", "ffn", "embed")}


def param_axes(name: str) -> Tuple[str, ...]:
    """The reference's logical axes of the port's parameter ``name`` (as
    ``named_parameters`` gives it), one per dimension of the port's
    tensor: a layer's axes without the stacked ``"layers"`` entry."""
    path, _ = jax_path(name)
    if len(path) >= 2 and path[-2] == "moe":
        return _MOE_AXES[path[-1]]
    return _LEAF_AXES[path[-1]]


def params_axes(model: LanguageModel) -> Dict[str, Tuple[str, ...]]:
    """:func:`param_axes` of every parameter of ``model``."""
    return {n: param_axes(n) for n, _ in model.named_parameters()}


def place_params(model: LanguageModel, mesh: DeviceMesh) -> LanguageModel:
    """Place ``model``'s weights over ``mesh`` IN PLACE and return it: each
    parameter becomes ``launch.mesh.place`` of it by
    ``sharding_for(mesh, shape, param_axes(name))`` (a
    :class:`~repro_torch.launch.mesh.Sharded` whose blocks lie on their
    owners' devices, or the tensor on the first rank where the spec
    splits nothing), set on its module in place of the parameter, and
    listed in ``model.placement``.  Nothing of a split weight stays
    whole: its blocks are copies and the parameter is dropped before the
    next is placed (the peak is the model and one weight's blocks).
    Every serving family serves placed (``models/lm.py
    PLACED_FAMILIES``): a moe FFN's router ``(embed, experts)``, experts
    ``(experts, embed, ffn)`` / ``(experts, ffn, embed)`` and shared
    experts as a dense MLP; a Mamba2 layer's ``w_in`` ``(embed,
    ssm_inner)`` (its column blocks straddle ``z | xBC | dt``), conv
    ``(conv_w, conv_ch)``, ``dt_bias`` / ``A_log`` / ``D``
    ``(ssm_heads_p,)``, ``gate_norm`` ``(ssm_inner,)`` and ``w_out``
    ``(ssm_inner, embed)``; an encdec's ``xattn.*``, ``ln_x``,
    ``enc_layers.*`` and ``enc_norm`` and the hybrid's ``shared.*`` as a
    decoder layer's."""
    if model.placement is not None:
        raise ValueError("the model's weights are placed already")
    values = {}
    # one parameter at a time: each whole weight is released as soon as
    # its blocks exist, so placing in place holds one extra weight at most
    for name in [n for n, _ in model.named_parameters()]:
        owner, attr = model, name
        if "." in name:
            path, attr = name.rsplit(".", 1)
            owner = model.get_submodule(path)
        p = owner._parameters.pop(attr)
        values[name] = place(p, sharding_for(mesh, tuple(p.shape),
                                             param_axes(name)))
        del p
        setattr(owner, attr, values[name])
    model.placement = Placement(mesh, values)
    return model


def from_jax_params(tree: Mapping, cfg: ModelConfig, device="cpu",
                    rc: RowCloneConfig = RowCloneConfig(),
                    param_dtype: Optional[torch.dtype] = None
                    ) -> LanguageModel:
    """Map the JAX parameter tree (numpy leaves) of a model of any family
    into a :class:`LanguageModel` on ``device``, every parameter through
    :func:`jax_path`.  ``param_dtype=torch.float32`` keeps the JAX fp32
    tree exactly (training's master weights); by default the matrices
    are rounded to the model dtype, as for serving."""
    device = resolve_device(device)
    model = build_model(cfg, device, rc, param_dtype=param_dtype)
    for name, p in model.named_parameters():
        path, idx = jax_path(name)
        a = tree
        for key in path:
            a = a[key]
        t = _to_torch(a if idx is None else np.asarray(a)[idx])
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} for a "
                             f"parameter of shape {tuple(p.shape)}")
        p.data.copy_(t.to(p.dtype))
    return model


__all__ = ["resolve_device", "init_params", "from_jax_params", "jax_path",
           "param_axes", "params_axes", "place_params"]
