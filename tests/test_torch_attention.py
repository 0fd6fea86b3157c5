"""The port's attention (the plain versions of K2 and K3, which the CPU
runs) against the JAX package's oracles and its Pallas kernels in
interpret mode.  Tolerances follow tests/test_kernels.py: atol 1e-4 for
fp32 (summation order only), 2e-2 for bf16 outputs (one bf16 ulp near 2-4).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_contract import to_torch

from repro.kernels import ref as jref
from repro.kernels.flash_attention import flash_attention_pallas
from repro.kernels.paged_attention import paged_attention_slab_pallas
from repro.models.attention import MaskInfo, lse_combine
from repro.models.attention import flash_attention as jax_model_flash
from repro_torch.kernels import ops
from repro_torch.kernels.flash_attention import tma_strides
from repro_torch.kernels.paged_attention import SPLITS
from repro_torch.models.attention import prefill_attention

NEG_INF = -1e30


def _paged_case(seed, B=4, H=8, KVH=2, D=64, page=16, nblk=16):
    """Pool slab with a CoW-shared prefix block (sequences 0 and 1), private
    tails, ragged lengths, and an empty sequence (slot B-1)."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = rng.standard_normal((nblk, page, KVH, D)).astype(np.float32)
    v = rng.standard_normal((nblk, page, KVH, D)).astype(np.float32)
    mask = np.zeros((nblk, B), np.int8)
    base = np.zeros(nblk, np.int32)
    lens = np.zeros(B, np.int32)
    free = list(rng.permutation(nblk))
    shared = free.pop()
    for b in range(B - 1):
        blocks = ([shared] if b < 2 else []) + \
            [free.pop() for _ in range(int(rng.integers(1, 3)))]
        for j, blk in enumerate(blocks):
            mask[blk, b] = 1
            base[blk] = j * page
        lens[b] = (len(blocks) - 1) * page + int(rng.integers(1, page + 1))
    return q, k, v, mask, base, lens


@pytest.mark.parametrize("seed", range(3))
def test_paged_attention_matches_reference_and_pallas(seed):
    q, k, v, mask, base, lens = _paged_case(seed)
    page = k.shape[1]
    got = ops.paged_attention_slab(*(to_torch(x) for x in
                                     (q, k, v, mask, base, lens)),
                                   page=page)
    want_ref = jref.paged_attention_slab(*(jnp.asarray(x) for x in
                                           (q, k, v, mask, base, lens)),
                                         page=page)
    want_pl = paged_attention_slab_pallas(*(jnp.asarray(x) for x in
                                            (q, k, v, mask, base, lens)),
                                          page=page, block_chunk=4,
                                          interpret=True)
    for want in (want_ref, want_pl):
        for name, a, b in zip(("acc", "l", "m"), got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                       rtol=1e-5, err_msg=name)
    acc, l, m = (t.numpy() for t in got)
    # the empty slot: m = -1e30 (not -inf), l = 0, acc = 0
    assert (m[-1] == np.float32(NEG_INF)).all()
    assert (l[-1] == 0).all() and (acc[-1] == 0).all()


def test_paged_attention_shared_block_serves_every_reader():
    """A CoW-shared block contributes to both sharers: dropping the second
    reader's column changes its output and nobody else's."""
    q, k, v, mask, base, lens = _paged_case(11)
    page = k.shape[1]
    full = ops.paged_attention_slab(*(to_torch(x) for x in
                                      (q, k, v, mask, base, lens)),
                                    page=page)
    cut = mask.copy()
    shared = int(np.nonzero(mask[:, 0] & mask[:, 1])[0][0])
    cut[shared, 1] = 0
    part = ops.paged_attention_slab(*(to_torch(x) for x in
                                      (q, k, v, cut, base, lens)),
                                    page=page)
    assert not torch.allclose(full[0][1], part[0][1])
    torch.testing.assert_close(full[0][0], part[0][0])


def _layout_case(seed, pages, B=4, H=8, KVH=2, D=64, page=16, nblk=96):
    """Pool slab where sequence b sees ``pages[b]`` blocks in a random block
    order (0 pages: an empty slot); sequences 0 and 1 share their first
    block (CoW), ragged lengths."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B, H, D)).astype(np.float32)
    k = rng.standard_normal((nblk, page, KVH, D)).astype(np.float32)
    v = rng.standard_normal((nblk, page, KVH, D)).astype(np.float32)
    mask = np.zeros((nblk, B), np.int8)
    base = np.zeros(nblk, np.int32)
    lens = np.zeros(B, np.int32)
    free = list(rng.permutation(nblk))
    shared = free.pop()
    for b, n in enumerate(pages):
        if not n:
            continue
        blocks = ([shared] if b < 2 else [free.pop()]) + \
            [free.pop() for _ in range(n - 1)]
        for j, blk in enumerate(blocks):
            mask[blk, b] = 1
            base[blk] = j * page
        lens[b] = (n - 1) * page + int(rng.integers(1, page + 1))
    return q, k, v, mask, base, lens


def _split_masks(mask, base, lens, splits=SPLITS):
    """The share mask of each CTA of K2's cluster: sequence b's visible
    blocks in block order, split ``s`` keeping positions
    ``[s n // splits, (s + 1) n // splits)`` of its ``n``."""
    out = np.zeros((splits,) + mask.shape, np.int8)
    for b in range(mask.shape[1]):
        vis = np.flatnonzero((mask[:, b] > 0) & (base < lens[b]))
        n = len(vis)
        for s in range(splits):
            out[s, vis[s * n // splits:(s + 1) * n // splits], b] = 1
    return out


def _merge(parts):
    """Rank 0's merge of the splits' (acc, l, m): ``lse_combine`` without
    its final division."""
    m = torch.stack([p[2] for p in parts]).amax(0)
    f = [torch.exp(p[2] - m) for p in parts]
    l = sum(fi * p[1] for fi, p in zip(f, parts))
    acc = sum(fi[..., None] * p[0] for fi, p in zip(f, parts))
    return acc, l, m


#: (pages per sequence) of the split-and-merge cases: more pages than
#: splits beside short sequences (whose splits are mostly empty) and an
#: empty slot; one page each; every slot empty
SPLIT_CASES = ((19, 3, 1, 0), (1, 1, 1, 1), (0, 0, 0, 0))


@pytest.mark.parametrize("pages", SPLIT_CASES,
                         ids=["long", "single", "all_empty"])
@pytest.mark.parametrize("seed", range(2))
def test_paged_attention_split_and_merge_matches_unsplit_and_jax(pages,
                                                                  seed):
    """K2's cluster emulated in plain torch: the plain version on each
    split's page range, merged as rank 0 merges them, equals the unsplit
    plain version and the JAX oracle (fp32, atol 1e-5 on the normalised
    output and m, rtol 1e-5 on l); empty splits add nothing, and an empty
    sequence stays m = -1e30, l = 0, acc = 0."""
    q, k, v, mask, base, lens = _layout_case(seed, pages)
    page = k.shape[1]
    masks = _split_masks(mask, base, lens)
    n_vis = masks.sum(axis=(0, 1))
    assert (n_vis == np.array(pages)).all()
    # min(n, SPLITS) splits hold pages, the rest none
    busy = (masks.sum(1) > 0).sum(0)
    assert (busy == np.minimum(pages, SPLITS)).all()
    qt, kt, vt, bt, lt = (to_torch(x) for x in (q, k, v, base, lens))
    parts = [ops.paged_attention_slab(qt, kt, vt, to_torch(ms), bt, lt,
                                      page=page) for ms in masks]
    acc, l, m = _merge(parts)
    full = ops.paged_attention_slab(qt, kt, vt, to_torch(mask), bt, lt,
                                    page=page)
    jax_out = jref.paged_attention_slab(*(jnp.asarray(x) for x in
                                          (q, k, v, mask, base, lens)),
                                        page=page)
    out = acc / l.clamp_min(1e-30)[..., None]
    for want in (full, tuple(torch.from_numpy(np.array(x))
                             for x in jax_out)):
        want_out = want[0] / want[1].clamp_min(1e-30)[..., None]
        np.testing.assert_allclose(out.numpy(), want_out.numpy(), atol=1e-5)
        np.testing.assert_allclose(m.numpy(), want[2].numpy(), atol=1e-5)
        np.testing.assert_allclose(l.numpy(), want[1].numpy(), atol=1e-5,
                                   rtol=1e-5)
    for b, n in enumerate(pages):
        if not n:
            assert (m[b] == np.float32(NEG_INF)).all()
            assert (l[b] == 0).all() and (acc[b] == 0).all()
    assert torch.isfinite(acc).all() and torch.isfinite(l).all()


@pytest.mark.parametrize("pages", SPLIT_CASES[:2], ids=["long", "single"])
def test_paged_attention_merge_rule_is_lse_combine(pages):
    """The merge of the split partials, normalised, is the reference's
    ``lse_combine`` over an axis of SPLITS members (``jax.vmap`` with an
    axis name), with empty splits among them."""
    q, k, v, mask, base, lens = _layout_case(7, pages)
    page = k.shape[1]
    qt, kt, vt, bt, lt = (to_torch(x) for x in (q, k, v, base, lens))
    parts = [ops.paged_attention_slab(qt, kt, vt, to_torch(ms), bt, lt,
                                      page=page)
             for ms in _split_masks(mask, base, lens)]
    acc, l, m = _merge(parts)
    got = acc / l.clamp_min(1e-30)[..., None]
    stacked = [jnp.asarray(np.stack([p[i].numpy() for p in parts]))
               for i in range(3)]
    want = jax.vmap(lambda a, ll, mm: lse_combine(a, ll, mm, "split"),
                    axis_name="split")(*stacked)
    for s in range(SPLITS):
        np.testing.assert_allclose(got.numpy(), np.asarray(want[s]),
                                   atol=1e-5)


@pytest.mark.parametrize("S", [50, 77, 128])
@pytest.mark.parametrize("prefix", [0, 9])
def test_prefill_attention_matches_reference_ragged(S, prefix):
    """Ragged prompt lengths against the naive oracle (fp32, atol 1e-4)."""
    rng = np.random.default_rng(S + prefix)
    B, H, KVH, D = 1, 6, 2, 32
    q = rng.standard_normal((B, H, S, D)).astype(np.float32)
    k = rng.standard_normal((B, KVH, S, D)).astype(np.float32)
    v = rng.standard_normal((B, KVH, S, D)).astype(np.float32)
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
    want = jref.flash_attention_ref(
        *(jnp.asarray(x).transpose(0, 2, 1, 3) for x in (q, k, v)), pos,
        pos, jnp.ones((B, S), bool), causal=True,
        prefix_len=prefix).transpose(0, 2, 1, 3)
    got = ops.flash_attention(to_torch(q), to_torch(k), to_torch(v),
                              causal=True, prefix_len=prefix)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("dtype,atol", [(jnp.float32, 1e-4),
                                        (jnp.bfloat16, 2e-2)])
@pytest.mark.parametrize("causal,prefix", [(True, 0), (True, 16),
                                           (False, 0)])
def test_prefill_attention_matches_pallas_interpret(dtype, atol, causal,
                                                    prefix):
    """Divisible S against the TPU kernel body in interpret mode."""
    B, H, KVH, S, D = 2, 4, 2, 64, 32
    keys = jax.random.split(jax.random.key(21), 3)
    q = jax.random.normal(keys[0], (B, H, S, D)).astype(dtype)
    k = jax.random.normal(keys[1], (B, KVH, S, D)).astype(dtype)
    v = jax.random.normal(keys[2], (B, KVH, S, D)).astype(dtype)
    want = flash_attention_pallas(q, k, v, causal=causal, prefix_len=prefix,
                                  bq=32, bk=32, interpret=True)
    got = ops.flash_attention(to_torch(q), to_torch(k), to_torch(v),
                              causal=causal, prefix_len=prefix)
    assert got.dtype == to_torch(q).dtype
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=atol)


def test_model_prefill_attention_matches_model_scan():
    """The model-layout entry (B, S, H, D) against the JAX model's scan
    (models/attention.py), ragged S, fp32 (atol 1e-4)."""
    rng = np.random.default_rng(5)
    B, S, H, KVH, D = 2, 45, 4, 2, 32
    q = rng.standard_normal((B, S, H, D)).astype(np.float32)
    k = rng.standard_normal((B, S, KVH, D)).astype(np.float32)
    v = rng.standard_normal((B, S, KVH, D)).astype(np.float32)
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
    want = jax_model_flash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                           pos, pos, jnp.ones((B, S), bool), MaskInfo(True, 0))
    got = prefill_attention(to_torch(q), to_torch(k), to_torch(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


@pytest.mark.parametrize("S,causal,prefix", [(45, True, 0), (70, True, 20),
                                              (33, False, 0)])
def test_prefill_attention_strided_views_match_contiguous(S, causal, prefix):
    """The transposed (B, S, H, D) views the model hands K3 and their
    contiguous copies give the same plain result, and prefill_attention
    (which passes the views) returns the (B, S, H, D) layout."""
    rng = np.random.default_rng(S)
    B, H, KVH, D = 2, 4, 2, 32
    q, k, v = (to_torch(rng.standard_normal((B, S, n, D)).astype(np.float32))
               for n in (H, KVH, KVH))
    views = [t.transpose(1, 2) for t in (q, k, v)]
    assert not any(t.is_contiguous() for t in views)
    got = ops.flash_attention(*views, causal=causal, prefix_len=prefix)
    want = ops.flash_attention(*(t.contiguous() for t in views),
                               causal=causal, prefix_len=prefix)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    model = prefill_attention(q, k, v, causal=causal, prefix_len=prefix)
    torch.testing.assert_close(model, want.transpose(1, 2), atol=0, rtol=0)


def test_tma_strides_take_views_and_refuse_the_rest():
    """K3's tensor maps take any (B, heads, S, D) view with a contiguous
    last dimension and 16-byte strides; size-1 dimensions get a valid
    stride; everything else is refused before a launch."""
    x = torch.zeros((2, 7, 4, 80), dtype=torch.bfloat16)      # (B, S, H, D)
    assert tma_strides("q", x.transpose(1, 2)) == (7 * 4 * 80, 80, 4 * 80)
    fused = torch.zeros((2, 7, 6 * 128), dtype=torch.bfloat16)
    kv = fused[..., 128:].unflatten(-1, (5, 128)).transpose(1, 2)
    assert tma_strides("k", kv) == (7 * 768, 128, 768)
    one = torch.zeros((1, 1, 5, 128), dtype=torch.bfloat16)
    assert tma_strides("q", one) == (128, 128, 128)
    for bad in (x.transpose(2, 3),                     # last dim strided
                torch.zeros((1, 2, 5, 20), dtype=torch.bfloat16),   # 40 B
                x[..., 1:].transpose(1, 2),            # unaligned data
                x[:1].expand(3, 7, 4, 80).transpose(1, 2)):   # stride 0
        with pytest.raises(ValueError):
            tma_strides("q", bad)


# ---------------------------------------------------------------------------
# head dim 256: paligemma-3b's 8 heads over 1 KV head
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,atol", [(jnp.float32, 1e-4),
                                        (jnp.bfloat16, 2e-2)])
@pytest.mark.parametrize("prefix", [16, 0])
def test_prefill_attention_at_head_dim_256_matches_pallas_and_model(
        dtype, atol, prefix):
    """The plain K3 at paligemma's head shape (H = 8 over KVH = 1, D = 256),
    causal with a prefix-LM prefix of 16 and without, against the TPU
    kernel body in interpret mode and against the JAX model's scan
    (``repro.models.attention.flash_attention``, (B, S, H, D) layout)."""
    B, H, KVH, S, D = 2, 8, 1, 64, 256
    rng = np.random.default_rng(256 + prefix)
    q, k, v = (jnp.asarray(rng.standard_normal((B, n, S, D))
                           .astype(np.float32)).astype(dtype)
               for n in (H, KVH, KVH))
    got = ops.flash_attention(to_torch(q), to_torch(k), to_torch(v),
                              causal=True, prefix_len=prefix)
    assert got.dtype == to_torch(q).dtype
    want_pl = flash_attention_pallas(q, k, v, causal=True, prefix_len=prefix,
                                     bq=32, bk=32, interpret=True)
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32), (B, S))
    want_model = jax_model_flash(
        *(x.transpose(0, 2, 1, 3) for x in (q, k, v)), pos, pos,
        jnp.ones((B, S), bool), MaskInfo(True, prefix)).transpose(0, 2, 1, 3)
    for want in (want_pl, want_model):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), atol=atol)


@pytest.mark.parametrize("pages", SPLIT_CASES[:2], ids=["long", "single"])
def test_paged_attention_at_head_dim_256_matches_pallas(pages):
    """The plain K2 and its split-and-merge emulation at paligemma's head
    shape (H = 8 over KVH = 1: group 8, D = 256) against the TPU kernel in
    interpret mode (fp32: acc, l, m atol 1e-4 rtol 1e-5, as above)."""
    q, k, v, mask, base, lens = _layout_case(3, pages, H=8, KVH=1, D=256,
                                             nblk=32)
    page = k.shape[1]
    want = paged_attention_slab_pallas(*(jnp.asarray(x) for x in
                                         (q, k, v, mask, base, lens)),
                                       page=page, block_chunk=4,
                                       interpret=True)
    qt, kt, vt, bt, lt = (to_torch(x) for x in (q, k, v, base, lens))
    full = ops.paged_attention_slab(qt, kt, vt, to_torch(mask), bt, lt,
                                    page=page)
    split = _merge([ops.paged_attention_slab(qt, kt, vt, to_torch(ms), bt,
                                             lt, page=page)
                    for ms in _split_masks(mask, base, lens)])
    for got in (full, split):
        for name, a, b in zip(("acc", "l", "m"), got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                       rtol=1e-5, err_msg=name)


# ---------------------------------------------------------------------------
# head dim 64 and Sq != Skv: seamless-m4t-medium's cross-attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype,atol", [(jnp.float32, 1e-4),
                                        (jnp.bfloat16, 2e-2)])
@pytest.mark.parametrize("Sq,Skv", [(64, 16), (1, 16)])
def test_cross_attention_at_head_dim_64_matches_pallas_and_model(
        dtype, atol, Sq, Skv):
    """The plain K3 at seamless's head dim 64 (4 heads over 4 KV heads),
    non-causal with Sq != Skv: the prefill cross-attention (64 text rows
    over 16 frames) and the decode step's (one query over 16 frames),
    against the TPU kernel body in interpret mode and against the JAX
    model's scan with zero positions and every frame valid (the
    reference's cross-attention call, ``transformer.py:103-121``)."""
    B, H, KVH, D = 2, 4, 4, 64
    rng = np.random.default_rng(64 + Sq)
    q = jnp.asarray(rng.standard_normal((B, H, Sq, D))
                    .astype(np.float32)).astype(dtype)
    k, v = (jnp.asarray(rng.standard_normal((B, KVH, Skv, D))
                        .astype(np.float32)).astype(dtype) for _ in range(2))
    got = ops.flash_attention(to_torch(q), to_torch(k), to_torch(v),
                              causal=False)
    assert got.dtype == to_torch(q).dtype and got.shape == (B, H, Sq, D)
    want_pl = flash_attention_pallas(q, k, v, causal=False, bq=32, bk=16,
                                     interpret=True)
    want_model = jax_model_flash(
        *(x.transpose(0, 2, 1, 3) for x in (q, k, v)),
        jnp.zeros((B, Sq), jnp.int32), jnp.zeros((B, Skv), jnp.int32),
        jnp.ones((B, Skv), bool), MaskInfo(causal=False)
    ).transpose(0, 2, 1, 3)
    for want in (want_pl, want_model):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32), atol=atol)


@pytest.mark.parametrize("Sq,Skv", [(64, 128), (128, 32)])
def test_causal_mask_with_sq_ne_skv_matches_pallas(Sq, Skv):
    """Causal with Sq != Skv keeps the Pallas kernel's mask, key column <=
    query row with both counted from 0 (fp32, D = 64)."""
    B, H, KVH, D = 1, 4, 2, 64
    rng = np.random.default_rng(Sq + Skv)
    q = rng.standard_normal((B, H, Sq, D)).astype(np.float32)
    k, v = (rng.standard_normal((B, KVH, Skv, D)).astype(np.float32)
            for _ in range(2))
    want = flash_attention_pallas(*(jnp.asarray(x) for x in (q, k, v)),
                                  causal=True, bq=32, bk=32, interpret=True)
    got = ops.flash_attention(to_torch(q), to_torch(k), to_torch(v))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4)


# ---------------------------------------------------------------------------
# The fp32 instances (the reduced configs' head dim 32), emulated in torch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pages", SPLIT_CASES,
                         ids=["long", "single", "all_empty"])
def test_paged_attention_split_and_merge_fp32_head_dim_32_matches_pallas(
        pages):
    """K2's fp32 instance at the reduced configs' head dim 32 (a CTA of 128
    threads: eight slot subsets an output pair), emulated as its cluster
    runs it: the plain version on each split's page range, merged as rank
    0 merges them, against the Pallas kernel in interpret mode (fp32, atol
    1e-4 on acc, l and m)."""
    q, k, v, mask, base, lens = _layout_case(3, pages, D=32, nblk=32)
    page = k.shape[1]
    qt, kt, vt, bt, lt = (to_torch(x) for x in (q, k, v, base, lens))
    parts = [ops.paged_attention_slab(qt, kt, vt, to_torch(ms), bt, lt,
                                      page=page)
             for ms in _split_masks(mask, base, lens)]
    got = _merge(parts)
    want = paged_attention_slab_pallas(*(jnp.asarray(x) for x in
                                         (q, k, v, mask, base, lens)),
                                       page=page, block_chunk=4,
                                       interpret=True)
    for name, a, b in zip(("acc", "l", "m"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-4,
                                   rtol=1e-5, err_msg=name)


#: K3's fp32 body: q rows of a CTA and keys of a K / V tile
K3_F32_TILE = 64


def _k3_f32_emulation(q, k, v, *, causal=True, prefix_len=0, q_offset=0,
                      skip=True):
    """K3's fp32 body in plain torch: 64-row q tiles, each walking the
    64-key tiles up to its last row's causal edge or the prefix (every
    tile with ``skip=False``), an online softmax in base 2 whose offset is
    0 while a row has seen no visible key, and O / l at the end."""
    B, H, Sq, D = q.shape
    Skv = k.shape[2]
    group = H // k.shape[1]
    kk = k.repeat_interleave(group, dim=1)
    vv = v.repeat_interleave(group, dim=1)
    sl2 = D ** -0.5 * float(np.log2(np.e))
    T = K3_F32_TILE
    out = torch.zeros_like(q)
    for q0 in range(0, Sq, T):
        n_kv = -(-Skv // T)
        if causal and skip:
            n_kv = min(n_kv, max((q0 + q_offset + T - 1) // T + 1,
                                 -(-prefix_len // T)))
        qt = q[:, :, q0:q0 + T]
        rows = torch.arange(q0, q0 + qt.shape[2])[:, None] + q_offset
        m = torch.full(qt.shape[:3], float("-inf"))
        l = torch.zeros(qt.shape[:3])
        o = torch.zeros_like(qt)
        for t in range(n_kv):
            cols = torch.arange(t * T, min((t + 1) * T, Skv))[None, :]
            s = qt @ kk[:, :, t * T:(t + 1) * T].transpose(-1, -2)
            ok = torch.ones_like(s, dtype=torch.bool)
            if causal:
                ok = (cols <= rows) | (cols < prefix_len)
            s = torch.where(ok, s, float("-inf"))
            mx = torch.maximum(m, s.amax(-1))
            base = torch.where(mx == float("-inf"), 0.0, mx * sl2)
            corr = torch.exp2(m * sl2 - base)
            p = torch.exp2(s * sl2 - base[..., None])
            l = l * corr + p.sum(-1)
            o = o * corr[..., None] + p @ vv[:, :, t * T:(t + 1) * T]
            m = mx
        out[:, :, q0:q0 + T] = o / l.clamp_min(1e-30)[..., None]
    return out


#: (Sq, Skv, causal, prefix, q_offset) of the fp32 body's mask modes: a
#: causal prompt over three tiles, with a prefix reaching past the first
#: row tile, non-causal with Sq != Skv both ways, and a block of query rows
#: (q_offset) whose causal edge straddles a key tile
K3_F32_MODES = ((192, 192, True, 0, 0), (128, 128, True, 80, 0),
                (64, 192, False, 0, 0), (192, 64, False, 0, 0),
                (64, 192, True, 0, 96))


@pytest.mark.parametrize("Sq,Skv,causal,prefix,q_offset", K3_F32_MODES,
                         ids=["causal", "prefix", "cross_wide",
                              "cross_narrow", "q_offset"])
def test_prefill_attention_fp32_head_dim_32_emulation_matches_pallas(
        Sq, Skv, causal, prefix, q_offset):
    """K3's fp32 body at head dim 32 with GQA (4 heads over 2), emulated
    tile by tile, against the Pallas kernel in interpret mode (fp32, atol
    1e-4); a block of query rows against the rows ``q_offset ..`` of the
    kernel's whole causal prompt.  The tiles the causal walk skips change
    nothing: the walk over every tile gives the same output."""
    B, H, KVH, D = 2, 4, 2, 32
    rng = np.random.default_rng(Sq + Skv + prefix + q_offset)
    q = rng.standard_normal((B, H, Sq, D)).astype(np.float32)
    k = rng.standard_normal((B, KVH, Skv, D)).astype(np.float32)
    v = rng.standard_normal((B, KVH, Skv, D)).astype(np.float32)
    kw = dict(causal=causal, prefix_len=prefix, q_offset=q_offset)
    got = _k3_f32_emulation(*(to_torch(x) for x in (q, k, v)), **kw)
    every = _k3_f32_emulation(*(to_torch(x) for x in (q, k, v)), **kw,
                              skip=False)
    if q_offset:
        whole = rng.standard_normal((B, H, Skv, D)).astype(np.float32)
        whole[:, :, q_offset:q_offset + Sq] = q
        want = np.asarray(flash_attention_pallas(
            jnp.asarray(whole), jnp.asarray(k), jnp.asarray(v),
            causal=True, prefix_len=prefix, bq=64, bk=64,
            interpret=True))[:, :, q_offset:q_offset + Sq]
    else:
        want = np.asarray(flash_attention_pallas(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
            prefix_len=prefix, bq=64, bk=64, interpret=True))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    np.testing.assert_allclose(every.numpy(), got.numpy(), atol=1e-6)
    plain = ops.flash_attention(*(to_torch(x) for x in (q, k, v)), **kw)
    assert plain.dtype == torch.float32
    np.testing.assert_allclose(plain.numpy(), want, atol=1e-4)
