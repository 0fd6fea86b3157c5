"""Weights of the port's dense model.

* :func:`init_params` makes random weights on the target device from a
  seeded ``torch.Generator``, with the scales of the reference's
  initialisers (``repro/models/common.py``): embedding N(0, 0.02), dense
  N(0, 1/in), norm gains zero.  Nothing is downloaded.
* :func:`from_jax_params` loads the JAX parameter tree (after
  ``split_params``, every leaf converted to numpy; layer weights stacked on
  a leading axis) into the port's modules, for the parity tests.

The JAX layout ``(in, out)`` is kept.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.configs import ModelConfig, RowCloneConfig
from repro_torch.models.lm import LanguageModel


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a GPU
    raises (entry points run on the card unless asked for the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the "
                           "plain versions on the CPU")
    return device


def init_params(cfg: ModelConfig, seed: int = 0, device="cuda",
                rc: RowCloneConfig = RowCloneConfig()) -> LanguageModel:
    """Random weights made on ``device`` from ``torch.Generator(seed)``."""
    device = resolve_device(device)
    model = LanguageModel(cfg, device, rc)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def normal_(p: torch.nn.Parameter, scale: float) -> None:
        # draw in fp32 then round, one weight at a time (bounded scratch)
        w = torch.randn(p.shape, generator=gen, device=device,
                        dtype=torch.float32)
        p.data.copy_(w.mul_(scale))

    normal_(model.embed, 0.02)
    if not cfg.tie_embeddings:
        normal_(model.lm_head, 0.02)
    for layer in model.layers:
        for name in ("wq", "wk", "wv", "w_gate", "w_up"):
            normal_(getattr(layer, name), cfg.d_model ** -0.5)
        normal_(layer.wo, cfg.q_dim ** -0.5)
        normal_(layer.w_down, cfg.d_ff ** -0.5)
    return model


def _to_torch(a) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(a))


def from_jax_params(tree: Mapping, cfg: ModelConfig, device="cpu",
                    rc: RowCloneConfig = RowCloneConfig()) -> LanguageModel:
    """Map the JAX dense parameter tree (numpy leaves) into a
    :class:`LanguageModel` on ``device``."""
    device = resolve_device(device)
    model = LanguageModel(cfg, device, rc)

    def put(p: torch.nn.Parameter, a) -> None:
        t = _to_torch(a)
        if tuple(t.shape) != tuple(p.shape):
            raise ValueError(f"shape {tuple(t.shape)} for a parameter of "
                             f"shape {tuple(p.shape)}")
        p.data.copy_(t.to(p.dtype))

    put(model.embed, tree["embed"])
    put(model.final_norm, tree["final_norm"])
    if not cfg.tie_embeddings:
        put(model.lm_head, tree["lm_head"])
    lay = tree["layers"]
    for i, layer in enumerate(model.layers):
        put(layer.ln1, lay["ln1"][i])
        put(layer.ln2, lay["ln2"][i])
        for name in ("wq", "wk", "wv", "wo"):
            put(getattr(layer, name), lay["attn"][name][i])
        for name in ("w_gate", "w_up", "w_down"):
            put(getattr(layer, name), lay["mlp"][name][i])
    return model


__all__ = ["resolve_device", "init_params", "from_jax_params"]
