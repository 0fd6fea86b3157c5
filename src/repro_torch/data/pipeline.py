"""Deterministic synthetic data pipeline with document packing (port of
``repro/data/pipeline.py``; :func:`make_batch` is the same numpy code, so
its batches are bitwise the reference's).

Batches are a pure function of (seed, step, arch): checkpoint / restart
replays identical data.  Documents are sampled with zipf-ish lengths from
a synthetic "corpus" (an affine successor chain with 10% noise), packed
into fixed-length rows with EOS separators; labels are next-token targets.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import ModelConfig

EOS = 1


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    mean_doc_len: int = 512
    eos_id: int = EOS


def _rng_for(seed: int, step: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence([seed, step]))


def make_batch(cfg: ModelConfig, batch: int, seq_len: int, step: int,
               data_cfg: Optional[DataConfig] = None) -> Dict[str, np.ndarray]:
    """One packed training batch (host numpy): ``tokens`` / ``labels``
    int32 and ``mask`` float32, (batch, seq_len); a vlm's text is
    shortened by its ``vision_tokens`` and ``patch_embeds`` (batch,
    vision_tokens, d_model) are added; an encdec gets ``src_embeds``
    (batch, seq_len // src_frames_ratio, d_model)."""
    dc = data_cfg or DataConfig()
    rng = _rng_for(dc.seed, step)
    V = cfg.vocab_size
    tokens = np.empty((batch, seq_len + 1), np.int32)
    for b in range(batch):
        row, fill = [], 0
        while fill < seq_len + 1:
            dlen = int(np.clip(rng.pareto(1.5) * dc.mean_doc_len, 8, 4096))
            # learnable structure: t -> (7t + 3) mod (V - 2) + 2, 10% noise
            doc = np.empty(dlen, np.int32)
            doc[0] = rng.integers(2, V)
            noise = rng.random(dlen) < 0.1
            rand = rng.integers(2, V, size=dlen)
            for t in range(1, dlen):
                doc[t] = rand[t] if noise[t] else \
                    (doc[t - 1] * 7 + 3) % (V - 2) + 2
            row.append(doc)
            row.append(np.array([dc.eos_id], np.int32))
            fill += dlen + 1
        tokens[b] = np.concatenate(row)[: seq_len + 1]
    out = {
        "tokens": tokens[:, :-1],
        "labels": tokens[:, 1:].astype(np.int32),
        "mask": np.ones((batch, seq_len), np.float32),
    }
    if cfg.family == "vlm":
        # stub frontend: deterministic patch embeddings; the text is
        # shortened so that the decoder's length stays seq_len
        p = cfg.vision_tokens
        text = seq_len - p
        out["tokens"] = out["tokens"][:, :text]
        out["labels"] = out["labels"][:, :text]
        out["mask"] = out["mask"][:, :text]
        out["patch_embeds"] = rng.standard_normal(
            (batch, p, cfg.d_model), np.float32) * 0.02
    if cfg.family == "encdec":
        s_src = max(seq_len // cfg.src_frames_ratio, 1)
        out["src_embeds"] = rng.standard_normal(
            (batch, s_src, cfg.d_model), np.float32) * 0.02
    return out


def batch_specs(cfg: ModelConfig, batch: int, seq_len: int
                ) -> Dict[str, Tuple[Tuple[int, ...], torch.dtype]]:
    """``(shape, dtype)`` of each field :func:`make_batch` returns."""
    text = seq_len - cfg.vision_tokens if cfg.family == "vlm" else seq_len
    s = {"tokens": ((batch, text), torch.int32),
         "labels": ((batch, text), torch.int32),
         "mask": ((batch, text), torch.float32)}
    if cfg.family == "vlm":
        s["patch_embeds"] = ((batch, cfg.vision_tokens, cfg.d_model),
                             torch.float32)
    if cfg.family == "encdec":
        s_src = max(seq_len // cfg.src_frames_ratio, 1)
        s["src_embeds"] = ((batch, s_src, cfg.d_model), torch.float32)
    return s


def batch_logical_axes(cfg: ModelConfig) -> Dict[str, Tuple]:
    ax = {"tokens": ("batch", None), "labels": ("batch", None),
          "mask": ("batch", None)}
    if cfg.family == "vlm":
        ax["patch_embeds"] = ("batch", None, None)
    if cfg.family == "encdec":
        ax["src_embeds"] = ("batch", None, None)
    return ax


def data_iterator(cfg: ModelConfig, batch: int, seq_len: int,
                  start_step: int = 0,
                  data_cfg: Optional[DataConfig] = None
                  ) -> Iterator[Dict[str, np.ndarray]]:
    step = start_step
    while True:
        yield make_batch(cfg, batch, seq_len, step, data_cfg)
        step += 1


def to_device(batch: Dict[str, np.ndarray], device
              ) -> Dict[str, torch.Tensor]:
    """A host batch as tensors on ``device`` (dtypes kept)."""
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}
