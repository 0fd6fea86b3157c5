"""Model and RowClone configuration of the port (a copy of what it needs
from ``repro/configs``): :class:`ModelConfig` with :meth:`ModelConfig.reduced`,
:class:`RowCloneConfig`, and the registry entries of the families the port
runs: the dense decoders it serves (llama3.2-3b, yi-6b, mistral-nemo-12b,
qwen2-72b with its QKV bias), the mixture-of-experts decoders it serves
(deepseek-moe-16b, phi3.5-moe-42b-a6.6b), the vision-language decoder
(paligemma-3b), the attention-free SSD stack (mamba2-780m), the Mamba2 +
shared-attention hybrid (zamba2-2.7b) and the encoder-decoder
(seamless-m4t-medium), the last four through
``LanguageModel.prefill_state`` / ``decode_state``; the training
hyper-parameters :class:`TrainConfig` and the input shapes
:data:`SHAPES`.
``tests/test_torch_contract.py`` pins the copy to the reference."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, Tuple

VOCAB_PAD_MULTIPLE = 256
#: the families the serving engine decodes
DECODER_FAMILIES = ("dense", "moe")


def pad_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclass(frozen=True)
class ModelConfig:
    """Architecture hyper-parameters.  The port runs every ``family`` of
    the reference: dense, moe, vlm, ssm, hybrid and encdec."""

    arch_id: str
    family: str
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    qkv_bias: bool = False
    rope_theta: float = 500000.0
    num_experts: int = 0
    top_k: int = 0
    num_shared_experts: int = 0
    moe_d_ff: int = 0
    ssm_state: int = 0
    ssm_heads: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_conv_width: int = 4
    ssm_chunk: int = 256
    shared_attn_every: int = 0
    encoder_layers: int = 0
    src_frames_ratio: int = 4
    vision_tokens: int = 0
    dtype: str = "bfloat16"
    tie_embeddings: bool = False
    norm_eps: float = 1e-5

    @property
    def padded_vocab(self) -> int:
        return pad_to(self.vocab_size, VOCAB_PAD_MULTIPLE)

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def has_subquadratic_path(self) -> bool:
        """The sequence-dependent state is O(1) (ssm) or attention is
        confined to a few shared blocks (hybrid)."""
        return self.family in ("ssm", "hybrid")

    @property
    def num_attn_layers(self) -> int:
        """Layers that own a KV cache: every layer of a dense, moe or vlm
        decoder and every decoder layer of an encdec (its self-attention),
        none of an SSD stack, one shared-block invocation per segment of a
        hybrid."""
        if self.family == "ssm":
            return 0
        if self.family == "hybrid":
            return self.num_layers // max(self.shared_attn_every, 1)
        return self.num_layers

    def reduced(self) -> "ModelConfig":
        """Tiny same-family variant for CPU tests (the reference's rule)."""
        return dataclasses.replace(
            self,
            arch_id=self.arch_id + "-smoke",
            num_layers=min(self.num_layers, 4),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 4) if self.num_kv_heads > 1
            else 1,
            head_dim=32,
            d_ff=256,
            moe_d_ff=64 if self.moe_d_ff else 0,
            vocab_size=512,
            num_experts=min(self.num_experts, 4),
            top_k=min(self.top_k, 2),
            num_shared_experts=min(self.num_shared_experts, 1),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_heads=8 if self.ssm_heads else 0,
            ssm_head_dim=32 if self.ssm_heads else 64,
            ssm_chunk=32,
            shared_attn_every=2 if self.shared_attn_every else 0,
            encoder_layers=2 if self.encoder_layers else 0,
            vision_tokens=16 if self.vision_tokens else 0,
            dtype="float32",
        )

    def param_count(self) -> int:
        """Analytic parameter count (the reference's)."""
        d, V = self.d_model, self.padded_vocab
        n = V * d
        if not self.tie_embeddings:
            n += V * d
        if self.family in ("ssm", "hybrid"):
            n += self.num_layers * (_mamba2_layer_params(self) + d)
            if self.family == "hybrid":
                n += _attn_block_params(self) + _mlp_params(self, self.d_ff)
            return n
        per_layer = _attn_block_params(self) + 2 * d
        if self.family == "moe":
            e_ff = self.moe_d_ff or self.d_ff
            per_layer += (self.num_experts + self.num_shared_experts) * \
                3 * d * e_ff + d * self.num_experts
        else:
            per_layer += _mlp_params(self, self.d_ff)
        n += self.num_layers * per_layer
        if self.family == "encdec":
            # the encoder layers, and each decoder layer's cross-attention
            # and its norm
            n += self.encoder_layers * (_attn_block_params(self) +
                                        _mlp_params(self, self.d_ff) + 2 * d)
            n += self.num_layers * (_attn_block_params(self) + d)
        return n

    def active_param_count(self) -> int:
        """Parameters a token uses (moe: its top_k and the shared
        experts)."""
        if self.family != "moe":
            return self.param_count()
        e_ff = self.moe_d_ff or self.d_ff
        return self.param_count() - self.num_layers * \
            (self.num_experts - self.top_k) * 3 * self.d_model * e_ff


def _mlp_params(cfg: ModelConfig, d_ff: int) -> int:
    return 3 * cfg.d_model * d_ff


def _attn_block_params(cfg: ModelConfig) -> int:
    d = cfg.d_model
    n = d * cfg.q_dim + 2 * d * cfg.kv_dim + cfg.q_dim * d
    if cfg.qkv_bias:
        n += cfg.q_dim + 2 * cfg.kv_dim
    return n


def _mamba2_layer_params(cfg: ModelConfig) -> int:
    d, di = cfg.d_model, cfg.ssm_d_inner
    n_h, st = cfg.ssm_heads, cfg.ssm_state
    return d * (2 * di + 2 * st + n_h) + di * cfg.ssm_conv_width + \
        2 * n_h + di * d


@dataclass(frozen=True)
class RowCloneConfig:
    """Settings for the in-memory copy/init engine (the paper's technique)."""
    enable_fpm: bool = True        # subarray-local block copy
    enable_psm: bool = True        # cross-slab copy
    enable_zi: bool = True         # lazy-zero + alias-copy (RowClone-ZI)
    page_size: int = 64            # tokens per KV block ("row" granularity)
    zero_blocks_per_slab: int = 1  # reserved zero rows per subarray


@dataclass(frozen=True)
class TrainConfig:
    """Training hyper-parameters (the reference's, every field and
    default).  ``remat_policy`` names a ``models/transformer.py
    REMAT_POLICIES`` entry; ``sharding`` picks the rules a step over a
    mesh runs under (``"fsdp"``: ``FSDP_RULES``, else ``DEFAULT_RULES``;
    ``launch/train.py``).  ``grad_compress`` is declared and read by
    nothing, as in the reference: its step calls no compressed all-reduce
    (``optim/compress.py``)."""
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    grad_clip: float = 1.0
    microbatches: int = 1          # gradient accumulation
    remat_policy: str = "minimal"  # none | minimal | dots
    sharding: str = "fsdp"         # fsdp | tp
    grad_compress: bool = False    # int8 error-feedback DP all-reduce
    seed: int = 0


@dataclass(frozen=True)
class ShapeConfig:
    """An input shape of the assigned set (the reference's)."""
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig
                     ) -> Tuple[bool, str]:
    """(runnable, reason): long_500k only for sub-quadratic archs."""
    if shape.name == "long_500k" and not cfg.has_subquadratic_path:
        return False, "pure full-attention arch: 500k context skipped per spec"
    return True, ""


_REGISTRY: Dict[str, ModelConfig] = {
    # llama3.2-3b: dense llama3-family decoder, 28L d_model=3072 24H
    # (GQA kv=8) d_ff=8192 vocab=128256, tied embeddings
    "llama3.2-3b": ModelConfig(
        arch_id="llama3.2-3b", family="dense", num_layers=28, d_model=3072,
        num_heads=24, num_kv_heads=8, head_dim=128, d_ff=8192,
        vocab_size=128256, rope_theta=500000.0, tie_embeddings=True),
    # mamba2-780m: attention-free SSD stack, 48L d_model=1536 vocab=50280,
    # ssm_state=128, d_inner 3072 = 48 SSD heads of head_dim 64
    "mamba2-780m": ModelConfig(
        arch_id="mamba2-780m", family="ssm", num_layers=48, d_model=1536,
        num_heads=0, num_kv_heads=0, head_dim=0, d_ff=0, vocab_size=50280,
        ssm_state=128, ssm_heads=48, ssm_head_dim=64, ssm_expand=2,
        tie_embeddings=True),
    # zamba2-2.7b: 54 Mamba2 layers d_model=2560 (80 SSD heads x 64,
    # ssm_state=64) with one shared attention+MLP block (32H, kv=32,
    # head_dim 80, d_ff=10240) after every 6 layers, vocab=32000
    "zamba2-2.7b": ModelConfig(
        arch_id="zamba2-2.7b", family="hybrid", num_layers=54, d_model=2560,
        num_heads=32, num_kv_heads=32, head_dim=80, d_ff=10240,
        vocab_size=32000, ssm_state=64, ssm_heads=80, ssm_head_dim=64,
        ssm_expand=2, shared_attn_every=6, rope_theta=10000.0),
    # yi-6b: llama-architecture GQA decoder, 32L d_model=4096 32H (GQA
    # kv=4) d_ff=11008 vocab=64000
    "yi-6b": ModelConfig(
        arch_id="yi-6b", family="dense", num_layers=32, d_model=4096,
        num_heads=32, num_kv_heads=4, head_dim=128, d_ff=11008,
        vocab_size=64000, rope_theta=5000000.0),
    # mistral-nemo-12b: dense GQA decoder, 40L d_model=5120 32H (GQA kv=8)
    # head_dim 128 (q_dim 4096 != d_model) d_ff=14336 vocab=131072
    "mistral-nemo-12b": ModelConfig(
        arch_id="mistral-nemo-12b", family="dense", num_layers=40,
        d_model=5120, num_heads=32, num_kv_heads=8, head_dim=128,
        d_ff=14336, vocab_size=131072, rope_theta=1000000.0),
    # qwen2-72b: dense GQA decoder with QKV bias, 80L d_model=8192 64H
    # (GQA kv=8) d_ff=29568 vocab=152064
    "qwen2-72b": ModelConfig(
        arch_id="qwen2-72b", family="dense", num_layers=80, d_model=8192,
        num_heads=64, num_kv_heads=8, head_dim=128, d_ff=29568,
        vocab_size=152064, qkv_bias=True, rope_theta=1000000.0),
    # deepseek-moe-16b: 28L d_model=2048 16H (kv=16, MHA), 64 routed
    # experts top-6 of d_ff 1408 plus 2 shared, vocab=102400
    "deepseek-moe-16b": ModelConfig(
        arch_id="deepseek-moe-16b", family="moe", num_layers=28,
        d_model=2048, num_heads=16, num_kv_heads=16, head_dim=128,
        d_ff=1408, vocab_size=102400, num_experts=64, top_k=6,
        num_shared_experts=2, rope_theta=10000.0),
    # phi3.5-moe-42b-a6.6b: 32L d_model=4096 32H (GQA kv=8), 16 experts
    # top-2 of d_ff 6400, no shared expert, vocab=32064
    "phi3.5-moe-42b-a6.6b": ModelConfig(
        arch_id="phi3.5-moe-42b-a6.6b", family="moe", num_layers=32,
        d_model=4096, num_heads=32, num_kv_heads=8, head_dim=128,
        d_ff=6400, vocab_size=32064, num_experts=16, top_k=2,
        rope_theta=10000.0),
    # paligemma-3b: gemma decoder behind 256 patch embeddings (prefix-LM
    # mask), 18L d_model=2048 8H (MQA kv=1) head_dim 256 d_ff=16384
    # vocab=257216, tied embeddings
    "paligemma-3b": ModelConfig(
        arch_id="paligemma-3b", family="vlm", num_layers=18, d_model=2048,
        num_heads=8, num_kv_heads=1, head_dim=256, d_ff=16384,
        vocab_size=257216, vision_tokens=256, rope_theta=10000.0,
        tie_embeddings=True),
    # seamless-m4t-medium: encoder-decoder, 12 encoder + 12 decoder layers
    # d_model=1024 16H (kv=16, MHA) head_dim 64 d_ff=4096 vocab=256206;
    # the audio frontend is a stub: the encoder reads precomputed frame
    # embeddings, src_len = seq_len // src_frames_ratio
    "seamless-m4t-medium": ModelConfig(
        arch_id="seamless-m4t-medium", family="encdec", num_layers=12,
        d_model=1024, num_heads=16, num_kv_heads=16, head_dim=64, d_ff=4096,
        vocab_size=256206, encoder_layers=12, src_frames_ratio=4,
        rope_theta=10000.0),
}


def get_config(arch_id: str) -> ModelConfig:
    try:
        return _REGISTRY[arch_id]
    except KeyError:
        raise KeyError(f"unknown arch {arch_id!r}; the port serves "
                       f"{sorted(_REGISTRY)}") from None


def list_archs():
    return sorted(_REGISTRY)


__all__ = ["DECODER_FAMILIES", "SHAPES", "ModelConfig", "RowCloneConfig",
           "ShapeConfig", "TrainConfig", "get_config", "list_archs",
           "pad_to", "shape_applicable"]
