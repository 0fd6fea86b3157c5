"""The port's CUDA kernels against their plain versions on the card: K1-K6
(tests marked ``cuda``; each skips where no GPU is visible), K2 and K3
also at the head groups of every served config and at every head dim, K3
with Sq != Skv.

This module imports only torch, numpy, pytest and ``repro_torch`` and makes
its inputs with numpy, so that it runs on the card's machine, which has no
JAX.  ``tests/conftest.py`` imports JAX, so run it there without the
conftest:

    PYTHONPATH=src python -m pytest -m cuda --noconftest tests/test_torch_card.py

``tests/test_torch_isolation.py`` refuses a ``jax`` or ``repro.`` import
here.  ``chip_smoke.py`` holds the same kernels at the models' full widths.
"""
import random

import numpy as np
import pytest
import torch

from repro_torch.core.opcodes import keys_clash, row_rw
from repro_torch.kernels import fused_dispatch as fd
from repro_torch.kernels import ops, ref
from repro_torch.kernels.fused_dispatch import wave_schedule

NEG_INF = -1e30


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


def bits(t: torch.Tensor) -> np.ndarray:
    """Raw bytes of a tensor, for bitwise comparison."""
    return t.detach().cpu().contiguous().view(torch.uint8).numpy().reshape(-1)


# ---------------------------------------------------------------------------
# K1, the fused drain
# ---------------------------------------------------------------------------

#: pool sizes and staging role vector of the drain case
RING = ([16, 16, 4, 4], (True, True, False, False))


def gen_table(rng, sizes, primary, n_rows):
    """Random contract ``[op, src, dst]`` rows: never two writes of one
    block, no read of a block an earlier row wrote (the queue's
    guarantee)."""
    _, total, locate = ref.address_space(sizes)
    nprim = sizes[primary.index(True)]
    rows, written = [], []
    for _ in range(50 * n_rows):
        if len(rows) >= n_rows:
            break
        op = rng.choice([0, 1, 2, 3, 4, 4, 5, 6, 7, -1])
        if op < 0:
            rows.append((-1, -1, -1))
            continue
        if op <= 3:
            s = -1 if op == 3 else rng.randrange(nprim)
            d = rng.randrange(nprim)
        elif op == 4:
            s, d = rng.randrange(total), rng.randrange(total)
        else:
            a = rng.randrange(total)
            b = a if op == 7 else rng.randrange(total)
            s, d = a * total + b, rng.randrange(total)
        reads, writes = row_rw(op, s, d, locate, total)
        if any(keys_clash(w, x, primary) for w in writes for x in written):
            continue
        if any(keys_clash(r, x, primary) for r in reads for x in written):
            continue
        rows.append((op, s, d))
        written.extend(writes)
    return np.asarray(rows, np.int32)


def _pools(seed, sizes):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((3, n, 4, 8))
                             .astype(np.float32)) for n in sizes]


def _zero_blocks(pools, device="cpu"):
    return [torch.zeros((1,) + tuple(p.shape[2:]), dtype=p.dtype,
                        device=device) for p in pools]


def _drain(pools, rows, primary):
    """Rows drained in the given order through the plain drain, one at a
    time (each row sees the state the rows before it left)."""
    pools = [p.clone() for p in pools]
    for row in rows:
        ref.fused_dispatch(pools, _zero_blocks(pools), np.asarray([row]),
                           block_axis=1, primary=primary)
    return pools


def _war_table(rng, sizes, primary, pools):
    """A contract table with non-adjacent WAR pairs whose order matters:
    its rows drained in reverse give other bytes than the whole table."""
    for _ in range(200):
        t = gen_table(rng, sizes, primary, 14)
        live = [tuple(r) for r in t.tolist() if r[0] >= 0]
        if max(wave_schedule(live, sizes, primary)) == 0:
            continue
        want = [p.clone() for p in pools]
        ref.fused_dispatch(want, _zero_blocks(want), t, block_axis=1,
                           primary=primary)
        back = _drain(pools, list(reversed(live)), primary)
        if any(not np.array_equal(bits(w), bits(b))
               for w, b in zip(want, back)):
            return t, want
    raise AssertionError("no order-sensitive WAR table drawn")


@pytest.mark.cuda
def test_cuda_drain_matches_plain_on_card(card):
    """K1 on the card against its plain version, bitwise, on a table
    whose WAR pairs make the order matter (chip_smoke.py covers the
    serving shapes)."""
    sizes, primary = RING
    pools = _pools(3, sizes)
    table, want = _war_table(random.Random(3), sizes, primary, pools)
    dev = [p.cuda() for p in pools]
    ops.fused_dispatch(dev, _zero_blocks(dev, "cuda"), table, block_axis=1,
                       primary=primary)
    for w, g in zip(want, dev):
        np.testing.assert_array_equal(bits(w), bits(g))


#: pool sizes of the K1 cases below: two primaries, two staging pools
WIDE = ([300, 300, 16, 16], (True, True, False, False))


def _contract_table(rng, sizes, primary, n_rows):
    """A random contract table (:func:`gen_table`) with a write-after-read
    pair whose order matters."""
    while True:
        t = gen_table(rng, sizes, primary, n_rows)
        live = [tuple(r) for r in t.tolist() if r[0] >= 0]
        if max(wave_schedule(live, sizes, primary)) > 0:
            return t


def _drain_held(pools, table, primary, block_axis, max_grid=0):
    """K1 (``fused_dispatch_cuda``) on card pools against its plain version
    on copies, bitwise, with ONE launch."""
    want = [p.clone() for p in pools]
    ref.fused_dispatch(want, _zero_blocks(want, "cuda"), table,
                       block_axis=block_axis, primary=primary)
    before = fd.COUNTER.n
    fd.fused_dispatch_cuda(pools, table, block_axis=block_axis,
                           primary=primary, max_grid=max_grid)
    torch.cuda.synchronize()
    assert fd.COUNTER.n - before == 1
    for w, g in zip(want, pools):
        np.testing.assert_array_equal(bits(w), bits(g))


@pytest.mark.cuda
def test_cuda_drain_above_the_parameters_room(card):
    """A table of more moves than the launch parameters carry goes through
    the stream's device buffer: still one launch, bitwise equal."""
    sizes, primary = WIDE
    pools = [p.cuda() for p in _pools(5, sizes)]
    table = _contract_table(random.Random(5), sizes, primary, 260)
    _drain_held(pools, table, primary, 1)
    assert fd.last_out[1] > fd.MOVE_CAPACITY


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16,
                                   torch.int32))
def test_cuda_drain_unaligned_pages(card, dtype):
    """Pages of 204 / 102 bytes, and 16-byte pages on a base 4 bytes off,
    drain through the word loop (every opcode, WAR pairs), bitwise."""
    sizes, primary = WIDE
    rng = np.random.default_rng(6)
    pools = [torch.from_numpy(rng.standard_normal((n, 3, 17)) * 100)
             .to(dtype).cuda() for n in sizes]
    table = _contract_table(random.Random(6), sizes, primary, 40)
    _drain_held(pools, table, primary, 0)
    assert fd.last_out[6] == 0
    pools = [torch.from_numpy(rng.standard_normal((n, 8, 128)))
             .to(dtype).cuda() for n in sizes]
    raw = torch.empty(pools[1].numel() + 1, dtype=dtype, device="cuda")
    pools[1] = raw[1:].view(pools[1].shape).copy_(pools[1])
    _drain_held(pools, table, primary, 0)
    assert fd.last_out[6] == 0


@pytest.mark.cuda
def test_cuda_drain_every_opcode_on_one_cta(card):
    """A grid of one CTA drains copy, zero, cross-pool and AND / OR / NOT
    moves and WAR waves through one shared-memory ring, bitwise."""
    sizes, primary = RING
    pools = [p.cuda() for p in _pools(8, sizes)]
    rng = random.Random(8)
    while True:
        table = _contract_table(rng, sizes, primary, 24)
        ops_in = {int(op) for op in table[:, 0]}
        if set(range(8)) <= ops_in:
            break
    _drain_held(pools, table, primary, 1, max_grid=1)
    assert fd.last_out[3] == 1


# ---------------------------------------------------------------------------
# K2 and K3, attention
# ---------------------------------------------------------------------------

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


@pytest.mark.cuda
def test_cuda_attention_kernels_match_plain_on_card(card):
    """K2 and K3 on the card against their plain versions (bf16 inputs;
    K2 atol 2e-3 on the normalised output, K3 atol 2e-2 on bf16 output).
    K2 also on a sequence of 64 visible pages (every CTA of the cluster
    busy), one page per sequence, and at head dim 80."""
    cases = [_paged_case(1, B=4, H=12, KVH=4, D=128, page=64, nblk=16)]
    for pages in ((64, 3, 1, 0), (1, 1, 1, 1)):
        for H, KVH, D in ((12, 4, 128), (8, 8, 80)):
            cases.append(_layout_case(2, pages, H=H, KVH=KVH, D=D, page=64,
                                      nblk=80))
    for case in cases:
        args = [torch.from_numpy(x).cuda() for x in case]
        for i in range(3):
            args[i] = args[i].bfloat16()
        acc, l, m = ops.paged_attention_slab(*args, page=64)
        acc_p, l_p, m_p = ops.paged_attention_slab(*args, page=64,
                                                   use_kernel=False)
        torch.testing.assert_close(acc / l.clamp_min(1e-30)[..., None],
                                   acc_p / l_p.clamp_min(1e-30)[..., None],
                                   atol=2e-3, rtol=0)
        torch.testing.assert_close(m, m_p, atol=2e-3, rtol=0)
        empty = args[5] == 0
        assert (m[empty] == NEG_INF).all() and (l[empty] == 0).all()
    rng = np.random.default_rng(0)
    for S, D, causal, prefix in ((64, 128, True, 0), (100, 128, True, 0),
                                 (1, 80, True, 0), (65, 80, True, 100),
                                 (130, 80, False, 0)):
        qq, kk, vv = (torch.from_numpy(rng.standard_normal((1, S, n, D))
                                       .astype(np.float32)).cuda()
                      .bfloat16().transpose(1, 2) for n in (8, 2, 2))
        torch.testing.assert_close(
            ops.flash_attention(qq, kk, vv, causal=causal,
                                prefix_len=prefix).float(),
            ops.flash_attention(qq, kk, vv, causal=causal, prefix_len=prefix,
                                use_kernel=False).float(),
            atol=2e-2, rtol=0)


@pytest.mark.cuda
def test_cuda_attention_kernels_at_head_dim_80_match_plain_on_card(card):
    """K2 and K3 at zamba2's head dim 80 (H = KVH: group 1) against their
    plain versions on the card (K2 atol 2e-3 on the normalised output, K3
    atol 2e-2 on its bf16 output)."""
    rng = np.random.default_rng(11)
    B, H, D, page, nblk = 3, 8, 80, 64, 12
    q, k, v = (torch.from_numpy(rng.standard_normal(shape)
                                .astype(np.float32))
               for shape in ((B, H, D), (nblk, page, H, D),
                             (nblk, page, H, D)))
    mask = np.zeros((nblk, B), np.int8)
    base = np.zeros(nblk, np.int32)
    for b in range(B):
        for j in range(3):
            mask[b * 4 + j, b] = 1
            base[b * 4 + j] = j * page
    lens = np.array([130, 64, 1], np.int32)
    args = [q.bfloat16().cuda(), k.bfloat16().cuda(), v.bfloat16().cuda()] \
        + [torch.from_numpy(a).cuda() for a in (mask, base, lens)]
    acc, l, m = ops.paged_attention_slab(*args, page=page)
    acc_p, l_p, m_p = ops.paged_attention_slab(*args, page=page,
                                               use_kernel=False)
    torch.testing.assert_close(acc / l[..., None], acc_p / l_p[..., None],
                               atol=2e-3, rtol=0)
    for S in (64, 250):
        qq, kk, vv = (torch.from_numpy(rng.standard_normal((1, 8, S, D))
                                       .astype(np.float32)).cuda().bfloat16()
                      for _ in range(3))
        torch.testing.assert_close(
            ops.flash_attention(qq, kk, vv).float(),
            ops.flash_attention(qq, kk, vv, use_kernel=False).float(),
            atol=2e-2, rtol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("H,KVH", [(32, 4), (16, 16)])
def test_cuda_attention_kernels_at_served_head_groups_match_plain_on_card(
        card, H, KVH):
    """K2 and K3 at head dim 128 with the head groups of the served
    configs: yi-6b's 32 heads over 4 KV heads (group 8, K2's largest) and
    deepseek-moe-16b's 16 over 16 (group 1), against their plain versions
    (K2 atol 2e-3 on the normalised output, K3 atol 2e-2 on bf16)."""
    for pages in ((64, 3, 1, 0), (2, 2, 5, 1)):
        case = _layout_case(7, pages, H=H, KVH=KVH, D=128, page=64, nblk=80)
        args = [torch.from_numpy(x).cuda() for x in case]
        for i in range(3):
            args[i] = args[i].bfloat16()
        acc, l, m = ops.paged_attention_slab(*args, page=64)
        acc_p, l_p, m_p = ops.paged_attention_slab(*args, page=64,
                                                   use_kernel=False)
        torch.testing.assert_close(acc / l.clamp_min(1e-30)[..., None],
                                   acc_p / l_p.clamp_min(1e-30)[..., None],
                                   atol=2e-3, rtol=0)
        torch.testing.assert_close(m, m_p, atol=2e-3, rtol=0)
        empty = args[5] == 0
        assert (m[empty] == NEG_INF).all() and (l[empty] == 0).all()
    rng = np.random.default_rng(13)
    for S in (1, 250, 512):
        qq, kk, vv = (torch.from_numpy(rng.standard_normal((1, S, n, 128))
                                       .astype(np.float32)).cuda()
                      .bfloat16().transpose(1, 2) for n in (H, KVH, KVH))
        torch.testing.assert_close(
            ops.flash_attention(qq, kk, vv).float(),
            ops.flash_attention(qq, kk, vv, use_kernel=False).float(),
            atol=2e-2, rtol=0)


@pytest.mark.cuda
def test_cuda_attention_kernels_at_head_dim_256_match_plain_on_card(card):
    """K2 and K3 at paligemma-3b's head shape, 8 heads over 1 KV head at
    D = 256 (a CTA of 256 threads in K2, two consumer warpgroups in K3),
    against their plain versions: K2 on a slab with a 64-page sequence,
    CoW-shared blocks and an empty slot, and on 7 pages each (atol 2e-3 on
    the normalised output and m); K3 with the 256-patch prefix and without,
    at a ragged S = 313 and S = 384, B = 1 and 4, and at S = 1 and 65
    (atol 2e-2 on its bf16 output)."""
    for pages in ((64, 3, 1, 0), (7, 7, 7, 7)):
        case = _layout_case(5, pages, H=8, KVH=1, D=256, page=64, nblk=96)
        args = [torch.from_numpy(x).cuda() for x in case]
        for i in range(3):
            args[i] = args[i].bfloat16()
        acc, l, m = ops.paged_attention_slab(*args, page=64)
        acc_p, l_p, m_p = ops.paged_attention_slab(*args, page=64,
                                                   use_kernel=False)
        torch.testing.assert_close(acc / l.clamp_min(1e-30)[..., None],
                                   acc_p / l_p.clamp_min(1e-30)[..., None],
                                   atol=2e-3, rtol=0)
        torch.testing.assert_close(m, m_p, atol=2e-3, rtol=0)
        empty = args[5] == 0
        assert (m[empty] == NEG_INF).all() and (l[empty] == 0).all()
    rng = np.random.default_rng(17)
    for B, S, prefix in ((1, 313, 256), (4, 384, 256), (1, 313, 0),
                         (4, 384, 0), (4, 65, 0), (1, 1, 0)):
        qq, kk, vv = (torch.from_numpy(rng.standard_normal((B, S, n, 256))
                                       .astype(np.float32)).cuda()
                      .bfloat16().transpose(1, 2) for n in (8, 1, 1))
        torch.testing.assert_close(
            ops.flash_attention(qq, kk, vv, prefix_len=prefix).float(),
            ops.flash_attention(qq, kk, vv, prefix_len=prefix,
                                use_kernel=False).float(),
            atol=2e-2, rtol=0)


@pytest.mark.cuda
def test_cuda_attention_kernels_at_head_dim_64_match_plain_on_card(card):
    """K2 and K3 at seamless-m4t-medium's head shape, 16 heads over 16 KV
    heads x 64, against their plain versions: K2 on a slab with a 64-page
    sequence, CoW-shared blocks and an empty slot, and on 2-5 pages each
    (atol 2e-3 on the normalised output and m); K3 causal at S = 512 and a
    ragged 57, non-causal at Sq = Skv = 14 (the encoder), and non-causal
    with Sq != Skv: 512 over 128 and 57 over 14 (prefill cross-attention),
    one query over 128 (the decode step's), and the edges Skv = 1 and 65
    over 200 (atol 2e-2 on its bf16 output)."""
    for pages in ((64, 3, 1, 0), (2, 2, 5, 1)):
        case = _layout_case(19, pages, H=16, KVH=16, D=64, page=64, nblk=80)
        args = [torch.from_numpy(x).cuda() for x in case]
        for i in range(3):
            args[i] = args[i].bfloat16()
        acc, l, m = ops.paged_attention_slab(*args, page=64)
        acc_p, l_p, m_p = ops.paged_attention_slab(*args, page=64,
                                                   use_kernel=False)
        torch.testing.assert_close(acc / l.clamp_min(1e-30)[..., None],
                                   acc_p / l_p.clamp_min(1e-30)[..., None],
                                   atol=2e-3, rtol=0)
        torch.testing.assert_close(m, m_p, atol=2e-3, rtol=0)
        empty = args[5] == 0
        assert (m[empty] == NEG_INF).all() and (l[empty] == 0).all()
    rng = np.random.default_rng(23)
    for B, Sq, Skv, causal in ((1, 512, 512, True), (1, 57, 57, True),
                               (2, 14, 14, False), (1, 512, 128, False),
                               (1, 57, 14, False), (4, 1, 128, False),
                               (1, 65, 1, False), (1, 65, 200, False)):
        qq = torch.from_numpy(rng.standard_normal((B, Sq, 16, 64)).astype(
            np.float32)).cuda().bfloat16().transpose(1, 2)
        kk, vv = (torch.from_numpy(rng.standard_normal((B, Skv, 16, 64))
                                   .astype(np.float32)).cuda().bfloat16()
                  .transpose(1, 2) for _ in range(2))
        got = ops.flash_attention(qq, kk, vv, causal=causal)
        assert got.shape == (B, 16, Sq, 64)
        torch.testing.assert_close(
            got.float(), ops.flash_attention(qq, kk, vv, causal=causal,
                                             use_kernel=False).float(),
            atol=2e-2, rtol=0)


#: the fp32 instances' limit: both sides sum fp32 products in other orders
F32_ATOL = 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("D", (32, 64, 80, 128, 256))
def test_cuda_attention_kernels_fp32_match_plain_on_card(card, D):
    """K2 and K3 on fp32 q / K / V at every head dim they take in fp32 (the
    reduced configs' 32, and 64-256), against their plain versions within
    atol 1e-4 (TF32 off: both sides fp32).  K2 on a slab with a 64-page
    sequence, CoW-shared blocks and an empty slot, and on 2-5 pages each,
    at group 4 and 1.  K3 causal (ragged, over three key tiles), with a
    prefix, non-causal with Sq != Skv both ways, one query, a block of
    query rows (``q_offset``), GQA, on the transposed (B, S, H, D) views
    the model passes; its output is fp32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    for H, KVH in ((8, 2), (4, 4)):
        for pages in ((64, 3, 1, 0), (2, 2, 5, 1)):
            case = _layout_case(29 + D, pages, H=H, KVH=KVH, D=D, page=64,
                                nblk=80)
            args = [torch.from_numpy(x).cuda() for x in case]
            acc, l, m = ops.paged_attention_slab(*args, page=64)
            acc_p, l_p, m_p = ops.paged_attention_slab(*args, page=64,
                                                       use_kernel=False)
            torch.testing.assert_close(
                acc / l.clamp_min(1e-30)[..., None],
                acc_p / l_p.clamp_min(1e-30)[..., None], atol=F32_ATOL,
                rtol=0)
            torch.testing.assert_close(m, m_p, atol=F32_ATOL, rtol=0)
            torch.testing.assert_close(l, l_p, atol=F32_ATOL, rtol=1e-5)
            empty = args[5] == 0
            assert (m[empty] == NEG_INF).all() and (l[empty] == 0).all()
    rng = np.random.default_rng(D)
    for B, Sq, Skv, causal, prefix, q_off in (
            (2, 150, 150, True, 0, 0), (1, 130, 130, True, 80, 0),
            (2, 64, 190, False, 0, 0), (1, 190, 14, False, 0, 0),
            (2, 1, 70, False, 0, 0), (1, 70, 200, True, 0, 130),
            (1, 1, 1, True, 0, 0)):
        qq = torch.from_numpy(rng.standard_normal((B, Sq, 8, D)).astype(
            np.float32)).cuda().transpose(1, 2)
        kk, vv = (torch.from_numpy(rng.standard_normal((B, Skv, 2, D))
                                   .astype(np.float32)).cuda()
                  .transpose(1, 2) for _ in range(2))
        kw = dict(causal=causal, prefix_len=prefix, q_offset=q_off)
        got = ops.flash_attention(qq, kk, vv, **kw)
        assert got.dtype == torch.float32 and got.shape == (B, 8, Sq, D)
        torch.testing.assert_close(
            got, ops.flash_attention(qq, kk, vv, use_kernel=False, **kw),
            atol=F32_ATOL, rtol=0)


@pytest.mark.cuda
def test_cuda_ssd_intra_chunk_head_dim_32_matches_plain_on_card(card):
    """K4's fp32 body at the reduced configs' head dim P = 32 and state 16:
    the reduced chunk (Q = 32, 8 heads), two tiles, and a ragged chunk of
    four, against its plain version within atol 1e-4."""
    for Q, H in ((32, 8), (96, 8), (250, 3)):
        args = [torch.from_numpy(a).cuda() for a in
                _chunk_case(Q + 1, 4, Q, H, 32, 16)]
        got = ops.ssd_intra_chunk(*args)
        want = ops.ssd_intra_chunk(*args, use_kernel=False)
        assert got.shape == (4, Q, H, 32)
        torch.testing.assert_close(got, want, atol=F32_ATOL, rtol=0)


@pytest.mark.cuda
def test_cuda_kernels_refuse_fp16_and_unlisted_shapes(card):
    """On CUDA tensors K2, K3 and K4 raise on what they do not take (fp16,
    bf16 at head dim 32, an unlisted fp32 head dim or P) and launch
    nothing: no fallback to the plain version."""
    from repro_torch.kernels.flash_attention import flash_attention_cuda
    from repro_torch.kernels.paged_attention import paged_attention_slab_cuda
    from repro_torch.kernels.ssd_chunk import ssd_intra_chunk_cuda
    before = {n: c.n for n, c in ops.KERNEL_COUNTERS.items()}
    tables = [torch.ones((3, 2), dtype=torch.int8, device="cuda"),
              torch.zeros(3, dtype=torch.int32, device="cuda"),
              torch.ones(2, dtype=torch.int32, device="cuda")]
    for dtype, D in ((torch.float16, 32), (torch.float16, 128),
                     (torch.bfloat16, 32), (torch.float32, 96)):
        q = torch.zeros((2, 4, D), dtype=dtype, device="cuda")
        kv = torch.zeros((3, 16, 4, D), dtype=dtype, device="cuda")
        with pytest.raises(ValueError):
            paged_attention_slab_cuda(q, kv, kv, *tables, page=16)
        qq = torch.zeros((1, 4, 8, D), dtype=dtype, device="cuda")
        with pytest.raises(ValueError):
            flash_attention_cuda(qq, qq, qq)
    for dtype, P in ((torch.float16, 64), (torch.bfloat16, 32),
                     (torch.float32, 16)):
        x = torch.zeros((1, 32, 2, P), dtype=dtype, device="cuda")
        f = torch.zeros((1, 32, 2), device="cuda")
        bc = torch.zeros((1, 32, 16), dtype=dtype, device="cuda")
        with pytest.raises(ValueError):
            ssd_intra_chunk_cuda(x, f, f, bc, bc)
    assert {n: c.n for n, c in ops.KERNEL_COUNTERS.items()} == before


@pytest.mark.cuda
def test_cuda_reduced_engine_matches_the_cpu_engine(card):
    """``ServingEngine`` at ``llama3.2-3b.reduced()`` (fp32, head dim 32)
    on the card through K1-K3 against the same engine on the CPU, from the
    same weights: 3 prompts, a round, a fork, 3 rounds, each card round fed
    the CPU engine's tokens.  Every round drains in at most one bulk
    launch; the card's greedy choices equal the CPU's but at a near-tie
    (a top-1 / top-2 margin within twice the two logits' largest
    difference); the logits agree
    within 2^-7 x max |logit| (the head is a bf16 product in either
    dtype, as the reference's, so a logit may step one bf16 ulp); the
    block tables are equal."""
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import ServingEngine
    from repro_torch.weights import init_params
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_config("llama3.2-3b").reduced()
    kw = dict(max_seqs=8)
    engines = {"cpu": ServingEngine(cfg, init_params(cfg, 0, "cpu"),
                                    device="cpu", **kw),
               "card": ServingEngine(cfg, init_params(cfg, 0, "cpu").to(
                   "cuda"), device="cuda", **kw)}
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab_size, size=n).astype(np.int32)
               for n in (24, 70, 5)]
    counted = {n: ops.KERNEL_COUNTERS[n].n for n in
               ("fused_dispatch", "paged_attention", "flash_attention")}
    sids = {n: [e.add_request(p) for p in prompts]
            for n, e in engines.items()}
    assert sids["cpu"] == sids["card"]
    k1 = ops.KERNEL_COUNTERS["fused_dispatch"]
    for rnd in range(4):
        if rnd == 1:
            for e in engines.values():
                e.fork(sids["cpu"][0], 2)
        live = sorted(engines["cpu"].cache.seqs)
        before = {s: engines["cpu"].last_logits[s].copy() for s in live}
        card_logits = {s: engines["card"].last_logits[s].copy()
                       for s in live}
        toks = engines["cpu"].decode_round()
        own = []

        def feed(logits, order=iter([toks[s] for s in sorted(toks)])):
            own.append(int(np.argmax(logits)))
            return next(order)

        n0 = k1.n
        assert engines["card"].decode_round(sample_fn=feed) == toks
        assert k1.n - n0 <= 1
        for s, mine in zip(sorted(toks), own):
            # a differing choice only at a near-tie of the CPU's logits
            top = np.sort(before[s])[-2:]
            assert mine == toks[s] or top[1] - top[0] <= 2 * float(
                np.abs(before[s] - card_logits[s]).max())
        cpu, got = engines["cpu"].last_logits, engines["card"].last_logits
        scale = max(float(np.abs(x).max()) for x in cpu.values())
        for s in cpu:
            assert float(np.abs(got[s] - cpu[s]).max()) <= 2 ** -7 * scale
    for n, c in counted.items():
        assert ops.KERNEL_COUNTERS[n].n > c, n
    cpu, card_e = engines["cpu"], engines["card"]
    for s in cpu.cache.seqs:
        assert card_e.cache.blocks_of(s) == cpu.cache.blocks_of(s)


# ---------------------------------------------------------------------------
# K4, the SSD intra-chunk term
# ---------------------------------------------------------------------------

def _chunk_case(seed, B, Q, H, P, N):
    """Intra-chunk inputs: dt softplus'd, ``cum`` an in-chunk cumsum of
    ``-0.2 dt`` (so <= 0 and decreasing)."""
    rng = np.random.default_rng(seed)
    xb = rng.standard_normal((B, Q, H, P)).astype(np.float32)
    dtb = np.log1p(np.exp(rng.standard_normal((B, Q, H)))).astype(np.float32)
    cum = np.cumsum(-0.2 * dtb, axis=1).astype(np.float32)
    Bm = rng.standard_normal((B, Q, N)).astype(np.float32)
    Cm = rng.standard_normal((B, Q, N)).astype(np.float32)
    return xb, dtb, cum, Bm, Cm


@pytest.mark.cuda
def test_cuda_ssd_intra_chunk_matches_plain_on_card(card):
    """K4 on the card against its plain version: bf16 and fp32 inputs, a
    full chunk and ragged ones, state sizes 32 to 256, partial head groups
    (max |diff| <= 1e-3 x max |plain|: fp32 sums in another order)."""
    for Q, H, N, dtype in ((256, 6, 32, torch.bfloat16),
                           (96, 6, 32, torch.bfloat16),
                           (250, 6, 32, torch.float32),
                           (256, 8, 128, torch.bfloat16),
                           (256, 5, 64, torch.bfloat16),
                           (250, 3, 256, torch.bfloat16)):
        xb, dtb, cum, Bm, Cm = (torch.from_numpy(a).cuda() for a in
                                _chunk_case(Q, 2, Q, H, 64, N))
        xb, Bm, Cm = (t.to(dtype) for t in (xb, Bm, Cm))
        got = ops.ssd_intra_chunk(xb, dtb, cum, Bm, Cm)
        want = ops.ssd_intra_chunk(xb, dtb, cum, Bm, Cm, use_kernel=False)
        torch.cuda.synchronize()
        assert float((got - want).abs().max()) <= \
            1e-3 * float(want.abs().max())


# ---------------------------------------------------------------------------
# K5a, K5b and K6, the block moves
# ---------------------------------------------------------------------------

#: the dtypes of tests/test_torch_copy_kernels.py
DTYPES = (torch.float32, torch.bfloat16, torch.int32)
#: [src, dst] rows: padding, and a write-after-read pair (row 4 rewrites
#: row 0's source)
IDS = np.array([[0, 5], [3, 7], [2, -1], [1, 9], [6, 0]], np.int32)
ZIDS = np.array([4, -1, 11, 2], np.int32)


def make_pool(seed, shape, dtype):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy((rng.standard_normal(shape) * 10)
                         .astype(np.float32))
    return x.to(torch.int32) if dtype == torch.int32 else x.to(dtype)


@pytest.mark.cuda
def test_cuda_copy_kernels_match_plain_on_card(card):
    """K5a, K5b and K6 against their plain versions on the card, both
    block axes, with padding and an in-call WAR pair; the small pages
    (4 KiB and 384 bytes down to 192) take the bulk copies where they are
    16-byte aligned and the word loop where not."""
    for ba, shape in ((0, (32, 8, 128)), (1, (3, 32, 4, 8)),
                      (0, (32, 3, 17))):
        for dtype in DTYPES:
            pool = make_pool(7, shape, dtype).cuda()
            src = make_pool(8, shape, dtype).cuda()
            cases = [
                (lambda p, k: ops.fpm_copy(p, IDS, block_axis=ba,
                                           use_kernel=k)),
                (lambda p, k: ops.fpm_copy_cross(p, src, IDS, block_axis=ba,
                                                 use_kernel=k)),
                (lambda p, k: ops.meminit_zero(p, ZIDS, block_axis=ba,
                                               use_kernel=k)),
            ]
            for fn in cases:
                want = fn(pool.clone(), False)
                got = fn(pool.clone(), True)
                torch.cuda.synchronize()
                np.testing.assert_array_equal(bits(got), bits(want))


# ---------------------------------------------------------------------------
# demote / resume through K1
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_demote_resume_roundtrip_through_k1(card):
    """The serving engine's preemption pair on the card, on its six-pool
    group (K/V, staging ring, spill pools; bf16 pages of 64 x 8 x 128):
    ``demote_to_spill`` parks three blocks in one K1 launch and the spill
    slots equal the blocks bitwise; ``promote_spilled`` lands them in
    fresh blocks in one K1 launch, bitwise; the slots return to the free
    list."""
    from repro_torch.core.allocator import SubarrayAllocator
    from repro_torch.core.rowclone import RowCloneEngine
    from repro_torch.models.paged import make_serving_pools
    L, nblk = 2, 32
    pools, group = make_serving_pools(L, nblk, 64, 8, 128, torch.bfloat16,
                                      "cuda", stage_nblk=8, ckpt_nblk=8)
    alloc = SubarrayAllocator(nblk, 4, reserved_zero_per_slab=1)
    eng = RowCloneEngine(pools, alloc, block_axis=1, group=group)
    eng.enable_demotion(range(8))
    blocks = alloc.alloc(3)
    gen = torch.Generator(device="cuda").manual_seed(0)
    for n in ("k", "v"):
        eng.pools[n][:, blocks] = torch.randn(
            (L, 3, 64, 8, 128), generator=gen, device="cuda").to(
                torch.bfloat16)
    alloc.mark_written(blocks)
    want = {n: eng.pools[n][:, blocks].clone() for n in ("k", "v")}
    k1 = ops.KERNEL_COUNTERS["fused_dispatch"]
    n0 = k1.n
    slots = eng.demote_to_spill(blocks)
    torch.cuda.synchronize()
    assert k1.n == n0 + 1 and eng.stats.demotions == 3
    for n in ("k", "v"):
        np.testing.assert_array_equal(
            bits(eng.pools[n + "_spill"][:, slots]), bits(want[n]))
    alloc.free(blocks)
    fresh = alloc.alloc(3, prefer_slab=1)
    assert fresh != blocks
    eng.promote_spilled(list(zip(slots, fresh)))
    torch.cuda.synchronize()
    assert k1.n == n0 + 2 and eng.stats.spill_promotions == 3
    for n in ("k", "v"):
        np.testing.assert_array_equal(bits(eng.pools[n][:, fresh]),
                                      bits(want[n]))
    assert eng.spill_slots_free == eng.spill_capacity == 8


# ---------------------------------------------------------------------------
# the traffic layer: preemption under the scheduler
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_scheduler_preemption_matches_same_batch_twin(card):
    """Two tenants over llama3.2-3b at full width cut to 2 layers: two free
    requests fill a 2-slot engine, a gold arrival preempts one (demote into
    the spill slots, resume later).  Every round drains at most one K1
    launch, the report's count agrees with the launch counter, and every
    request's tokens equal, bitwise, those of a same-batch twin
    (``max_seqs=2`` without spill slots: gold waits, nothing is
    preempted), whose decode GEMMs have the same shapes."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.scheduler import RequestScheduler, TenantSpec
    from repro_torch.launch.serve import ServingEngine
    from repro_torch.weights import init_params
    cfg = dataclasses.replace(get_config("llama3.2-3b"), num_layers=2)
    model = init_params(cfg, seed=0, device="cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab_size, size=16).astype(np.int32)
               for _ in range(3)]
    k1 = ops.KERNEL_COUNTERS["fused_dispatch"]

    def drive(spill_pages):
        eng = ServingEngine(cfg, model, max_seqs=2, max_blocks_per_seq=8,
                            num_slabs=2, max_admit_pages=8,
                            double_buffer=True, spill_pages=spill_pages)
        sched = RequestScheduler(eng, [TenantSpec("gold", 2),
                                       TenantSpec("free", 0)])
        rids = [sched.submit("free", p, max_new_tokens=8)
                for p in prompts[:2]]
        per_round, ticket = [], None
        while not sched.idle:
            if len(sched.reports) == 2:
                rids.append(sched.submit("gold", prompts[2],
                                         max_new_tokens=8))
            n0 = k1.n
            rep = sched.step()
            fresh = eng.last_ticket is not ticket
            ticket = eng.last_ticket
            per_round.append((k1.n - n0, rep.launches if fresh else 0))
            assert len(sched.reports) < 60
        torch.cuda.synchronize()
        return ([sched.requests[r].tokens_out for r in rids],
                sum(q.preemptions for q in sched.requests.values()),
                per_round)

    tight, preempted, rounds = drive(8)
    twin, twin_preempted, twin_rounds = drive(0)
    assert preempted > 0 and twin_preempted == 0
    for got, reported in rounds + twin_rounds:
        assert got <= 1 and got == reported
    assert [len(t) for t in tight] == [8, 8, 8]
    assert tight == twin


# ---------------------------------------------------------------------------
# the recovery path
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_launch_failure_recovers_token_identical(card, tmp_path):
    """llama3.2-3b at full width cut to 2 layers, with the checkpoint
    stream: a launch failure injected on round 1's drain and a donation
    error on the third admission, both recovered in place (the evicted
    prompt re-admitted).  Greedy tokens equal a clean twin's bitwise, every
    round after the fault drains at most one K1 launch, and a killed pool
    makes K1's wrapper raise instead of launching."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import ServingEngine
    from repro_torch.runtime.fault import FaultPlan, InjectedFault
    from repro_torch.weights import init_params
    cfg = dataclasses.replace(get_config("llama3.2-3b"), num_layers=2)
    model = init_params(cfg, seed=0, device="cuda")
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab_size, size=24).astype(np.int32)
               for _ in range(3)]
    k1 = ops.KERNEL_COUNTERS["fused_dispatch"]

    def drive(plan, sub):
        eng = ServingEngine(cfg, model, max_seqs=8, max_blocks_per_seq=16,
                            fault_plan=plan, auto_recover=plan is not None,
                            ckpt_pages=8, ckpt_dir=str(tmp_path / sub))
        order = [eng.add_request(p) for p in prompts[:2]]
        per_round = []
        for r in range(6):
            if r == 1 and plan is not None:
                plan.launch_failures += (eng.engine.next_flush_index,)
            if r == 3:
                if plan is not None:
                    plan.donation_errors += (eng._admission_ordinal,)
                    with pytest.raises(InjectedFault):
                        eng.add_request(prompts[2])
                order.append(eng.add_request(prompts[2]))
            n0 = k1.n
            eng.decode_round()
            t = eng.last_ticket
            per_round.append((k1.n - n0, t.launches if t else -1))
        torch.cuda.synchronize()
        return eng, [eng.tokens[s] for s in order], per_round

    _, clean, _ = drive(None, "clean")
    plan = FaultPlan()
    eng, got, per_round = drive(plan, "fault")
    assert [k for k, _ in plan.fired] == ["launch_failure", "donation_error"]
    assert len(eng.evicted_sids) == 1 and eng.last_recovery is not None
    assert got == clean
    # after the fault round: the serve flush drains in <= 1 K1 launch,
    # and the checkpoint window adds one
    for total, serve in per_round[2:]:
        assert 0 <= serve <= 1 and total == serve + 1
    assert eng.pool_ckpt._cursor > 0 or eng.pool_ckpt.passes > 0
    eng.engine.kill_pool("v")
    n0 = k1.n
    with pytest.raises(RuntimeError, match="no storage"):
        ops.fused_dispatch(tuple(eng.engine.pools.values()),
                           eng.engine._get_zero_blocks(),
                           np.array([[0, 0, 1]], np.int32))
    torch.cuda.synchronize()
    assert k1.n == n0


# ---------------------------------------------------------------------------
# the drain sanitizer: K1 held to its plain version on live tables
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_cuda_sanitized_drain_shadow_check(card):
    """A sanitized engine over serving-shaped bf16 pools on the card
    (K/V and a staging ring, pages of 64 x 8 x 128): copies, zero inits
    and promotions drain through K1 in one launch a flush, and every
    chunk's shadow drain (the plain version on host copies) agrees bit for
    bit.  A planted K1 whose output differs in one block then raises
    ``SanitizerError`` with a ``shadow-diff`` finding only, and the flush
    is stashed for ``recover()``."""
    from repro_torch.core.allocator import SubarrayAllocator
    from repro_torch.core.poolspec import BlockRef
    from repro_torch.core.rowclone import RowCloneEngine
    from repro_torch.core.sanitizer import SanitizerError
    from repro_torch.models.paged import make_serving_pools
    L, nblk = 2, 32
    pools, group = make_serving_pools(L, nblk, 64, 8, 128, torch.bfloat16,
                                      "cuda", stage_nblk=8)
    gen = torch.Generator(device="cuda").manual_seed(1)
    for p in pools.values():
        p.copy_(torch.randn(p.shape, generator=gen, device="cuda"))
    alloc = SubarrayAllocator(nblk, 4, reserved_zero_per_slab=1)
    eng = RowCloneEngine(pools, alloc, block_axis=1, group=group,
                         sanitize=True)
    k1 = ops.KERNEL_COUNTERS["fused_dispatch"]
    n0 = k1.n
    src = alloc.alloc(4)
    alloc.mark_written(src)
    dst = alloc.alloc(6)
    s = eng.stream("serve")
    s.memcopy(list(zip(src, dst[:4])))
    s.materialize_zeros(dst[4:5])
    s.promote_staged([(0, dst[5])])
    t = s.flush()
    torch.cuda.synchronize()
    san = eng.sanitizer
    assert t.launches == 1 and k1.n == n0 + 1
    assert san.tables_checked == san.shadow_runs == 1
    assert all(r.ok for r in san.reports)
    real = ops.fused_dispatch

    def bad(pools, zero_blocks, cmds, **kw):
        out = real(pools, zero_blocks, cmds, **kw)
        pools[0].select(1, 2).view(torch.int16).bitwise_xor_(1)
        return out

    ops.fused_dispatch = bad
    try:
        more = alloc.alloc(2)
        with pytest.raises(SanitizerError) as ei:
            eng.memcopy([(src[0], more[0]), (src[1], more[1])])
    finally:
        ops.fused_dispatch = real
    assert {f.check for f in ei.value.report.findings} == {"shadow-diff"}
    assert "pool 'k': 1 block(s)" in str(ei.value)
    assert len(eng._aborted) == 1 and san.shadow_runs == 2


# ---------------------------------------------------------------------------
# K7, the PSM transfer, and the sharded drain over a rank mesh on one card
# ---------------------------------------------------------------------------

def mesh_rows(rng, n, ss, skip=0.2):
    """(n, m, 3) per-rank rows at every hop -(n-1) .. n-1, with skip rows:
    sources in the low half of each slab, destinations in the high half,
    never two rows writing one block."""
    ids = np.full((n, 2 * n - 1, 3), -1, np.int64)
    free = {r: list(rng.permutation(np.arange(ss // 2, ss))) for r in range(n)}
    for my in range(n):
        for j, hop in enumerate(range(-(n - 1), n)):
            tgt = (my + hop + n) % n
            if rng.random() < skip or not free[tgt]:
                continue
            ids[my, j] = (rng.integers(0, ss // 2), free[tgt].pop(), hop)
    return ids


@pytest.mark.cuda
def test_cuda_psm_transfer_matches_plain_on_card(card):
    """K7 over 4 and 8 ranks on one card against its plain version,
    bitwise, one launch a call: both block axes, 2- and 4-byte dtypes,
    16-byte pages and pages the word loop takes 4 bytes at a time."""
    from repro_torch.kernels import psm_transfer as k7
    rng = np.random.default_rng(7)
    for n in (4, 8):
        for ba, blk in ((0, (8, 128)), (1, (8, 128)), (0, (3, 17))):
            for dtype in (torch.bfloat16, torch.float32, torch.int16):
                ss = 16
                shape = (ss,) + blk if ba == 0 else (3, ss) + blk
                slabs = [make_pool(100 + r, shape, torch.float32).to(dtype)
                         .cuda() for r in range(n)]
                ids = mesh_rows(rng, n, ss)
                want = ops.psm_transfer([s.clone() for s in slabs], ids,
                                        block_axis=ba, use_kernel=False)
                n0 = k7.COUNTER.n
                got = ops.psm_transfer([s.clone() for s in slabs], ids,
                                       block_axis=ba)
                torch.cuda.synchronize()
                assert k7.COUNTER.n == n0 + 1
                for g, w in zip(got, want):
                    np.testing.assert_array_equal(bits(g), bits(w))


@pytest.mark.cuda
def test_cuda_psm_copy_launches_k7_and_never_the_plain_version(card,
                                                               monkeypatch):
    """``ops.psm_copy`` on a CUDA pool runs K7 (one launch per wave: a
    write-after-read pair makes two) and never reaches ``kernels/ref.py``;
    a K7 that does not build raises instead of running the plain
    version."""
    from repro_torch.kernels import build
    from repro_torch.kernels import psm_transfer as k7
    pool = make_pool(3, (32, 8, 128), torch.bfloat16).cuda()
    ids = np.array([[0, 5], [3, 7], [2, -1], [1, 9], [6, 0]], np.int32)
    want = ops.psm_copy(pool.clone(), ids, use_kernel=False)

    def refuse(*a, **k):
        raise AssertionError("the plain version ran on a CUDA tensor")

    for name in ("fpm_copy", "psm_transfer", "fpm_copy_cross"):
        monkeypatch.setattr(ref, name, refuse)
    n0 = k7.COUNTER.n
    got = ops.psm_copy(pool.clone(), ids)
    torch.cuda.synchronize()
    np.testing.assert_array_equal(bits(got), bits(want))
    assert k7.COUNTER.n == n0 + 2             # [6, 0] rewrites row 0's source

    def no_build(name):
        raise build.KernelBuildError("nvcc refused the source")

    k7._entry.cache_clear()
    monkeypatch.setattr(k7, "library", no_build)
    try:
        with pytest.raises(build.KernelBuildError):
            ops.psm_copy(pool.clone(), ids)
        with pytest.raises(build.KernelBuildError):
            ops.psm_transfer([pool.clone(), pool.clone()],
                             np.array([[[0, 1, 1]], [[-1, 0, 0]]]))
    finally:
        k7._entry.cache_clear()


def _offset_slab(seed, shape, dtype, offset):
    """A contiguous slab whose base lies ``offset`` bytes past a 16-byte
    boundary (a view into a larger byte buffer)."""
    src = make_pool(seed, shape, dtype).cuda()
    nbytes = src.numel() * src.element_size()
    raw = torch.empty(nbytes + 16, dtype=torch.uint8, device="cuda")
    out = raw[offset:offset + nbytes].view(dtype).view(shape)
    out.copy_(src)
    return out


@pytest.mark.cuda
def test_cuda_psm_transfer_routes_and_row_buffer(card):
    """K7 in ONE launch a call, bitwise against its plain version, over
    each route the host picks from the geometry: the bulk copies (16-byte
    aligned pages and bases), the word loop (a 102-byte page, and a base 8
    bytes off), and a call of more rows than the launch parameters carry
    (the rows through the pinned and the device buffer), twice in a row on
    one stream."""
    from repro_torch.kernels import psm_transfer as k7
    rng = np.random.default_rng(11)
    n = 8
    cases = [("bulk", (2, 64, 8, 128), torch.bfloat16, 0, 1, 16),
             ("word, 102-byte page", (3, 16, 3, 17), torch.bfloat16, 0, 0, 2),
             ("word, base 8 bytes off", (16, 8, 128), torch.float32, 8, 0, 8)]
    for what, shape, dtype, off, bulk, word in cases:
        ba = 1 if len(shape) == 4 else 0
        slabs = [_offset_slab(200 + r, shape, dtype, off if r == 0 else 0)
                 for r in range(n)]
        ids = mesh_rows(rng, n, shape[ba])
        want = ops.psm_transfer([s.clone() for s in slabs], ids,
                                block_axis=ba, use_kernel=False)
        n0 = k7.COUNTER.n
        got = ops.psm_transfer(slabs, ids, block_axis=ba)
        torch.cuda.synchronize()
        assert k7.COUNTER.n == n0 + 1, what
        assert (k7.last_out[5], k7.last_out[6], k7.last_out[7]) == \
            (bulk, word, 0), what
        for g, w in zip(got, want):
            np.testing.assert_array_equal(bits(g), bits(w), what)
    # 8 ranks x 40 rows: above ROW_CAPACITY
    ss = 96
    slabs = [make_pool(300 + r, (ss, 8, 128), torch.bfloat16).cuda()
             for r in range(n)]
    for rep in range(2):
        ids = np.full((n, 40, 3), -1, np.int64)
        free = {r: list(rng.permutation(np.arange(ss // 2, ss)))
                for r in range(n)}
        for my in range(n):
            for j in range(40):
                hop = int(rng.integers(-(n - 1), n))
                tgt = (my + hop + n) % n
                if free[tgt]:
                    ids[my, j] = (rng.integers(0, ss // 2), free[tgt].pop(),
                                  hop)
        live = int((ids[:, :, 0] >= 0).sum())
        assert live > k7.ROW_CAPACITY
        want = ops.psm_transfer([s.clone() for s in slabs], ids,
                                use_kernel=False)
        n0 = k7.COUNTER.n
        ops.psm_transfer(slabs, ids)
        torch.cuda.synchronize()
        assert k7.COUNTER.n == n0 + 1 and k7.last_out[7] == 1, rep
        assert k7.last_out[0] == live
        for g, w in zip(slabs, want):
            np.testing.assert_array_equal(bits(g), bits(w))


@pytest.mark.cuda
def test_cuda_psm_refusals_come_from_the_library(card, monkeypatch):
    """On CUDA slabs every K7 caller reaches the C entry without
    ``check_rows``: each refusal of the contract is raised by the library
    with ``check_rows``'s message, before any launch (no launch counted,
    the slabs untouched), and a row reading the block it writes runs."""
    from repro_torch.kernels import fused_dispatch as fdm
    from repro_torch.kernels import psm_transfer as k7
    slabs = [make_pool(400 + r, (4, 2, 64), torch.float32).cuda()
             for r in range(4)]
    t = [(slabs, slabs)]
    bad = [[[0, 0, 1, 2, 4]], [[0, 5, 1, 2, 1]], [[0, 0, 4, 2, 1]],
           [[1, 0, 1, 2, 1]], [[0, 0, 1, 2, 1], [0, 2, 3, 2, -1]],
           [[0, 0, 1, 2, 1], [0, 1, 2, 3, 1]]]
    messages = []
    for rows in bad:
        with pytest.raises(ValueError) as ei:
            k7.check_rows(t, rows, 0)
        messages.append(str(ei.value))
    before = [bits(s) for s in slabs]

    def refuse(*a, **k):
        raise AssertionError("check_rows ran on the card path")

    for mod in (k7, ops, fdm):
        if hasattr(mod, "check_rows"):
            monkeypatch.setattr(mod, "check_rows", refuse)
    n0 = k7.COUNTER.n
    for rows, msg in zip(bad, messages):
        with pytest.raises(ValueError) as ei:
            ops.psm_transfer_rows(t, rows)
        assert str(ei.value) == msg
    torch.cuda.synchronize()
    assert k7.COUNTER.n == n0
    for s, b in zip(slabs, before):
        np.testing.assert_array_equal(bits(s), b)
    assert ops.psm_transfer_rows(t, [[0, 1, 2, 2, 0]]) == 1
    torch.cuda.synchronize()
    assert k7.COUNTER.n == n0 + 1


@pytest.mark.cuda
def test_cuda_mesh_engine_matches_the_plain_mesh_engine(card):
    """An engine over 8 ranks on one card (layer-stacked bf16 pools and a
    staging pair) drains a flush of copies within and across ranks, zero
    rows, cross-pool and AND / OR / NOT rows through ONE sharded drain (K7
    and K1 launched) to pools bitwise equal to the same engine over 8 CPU
    ranks (the plain versions); then the fan-out leg (K5a, K6, K7)."""
    from repro_torch.core.allocator import SubarrayAllocator
    from repro_torch.core.poolspec import BlockRef
    from repro_torch.core.rowclone import RowCloneEngine
    from repro_torch.launch.mesh import make_test_mesh
    nblk, snblk = 64, 16

    def engine(device, use_fused):
        pools = {n: make_pool(i, (3, nb, 8, 128), torch.float32)
                 .to(torch.bfloat16) for i, (n, nb) in enumerate(
                     (("k", nblk), ("v", nblk), ("k_stage", snblk),
                      ("v_stage", snblk)))}
        mesh = make_test_mesh((2, 4), ("data", "model"), devices=device)
        eng = RowCloneEngine(pools, SubarrayAllocator(nblk, 4), mesh=mesh,
                             block_axis=1, use_fused=use_fused,
                             staging={"k_stage": "k", "v_stage": "v"})
        eng.alloc.mark_written(list(range(nblk)))
        return eng

    def script(eng):
        with eng.batch():
            eng.memcopy([(1, 2), (3, 40), (17, 60), (9, 33)])
            eng.materialize_zeros([5, 50])
            eng.memcopy_cross([(BlockRef("k_stage", 3), BlockRef("k", 20)),
                               (BlockRef("k", 44), BlockRef("v_stage", 9))])
            eng.memand([(BlockRef("k", 10), BlockRef("v", 55),
                         BlockRef("v", 30))])
            eng.memor([(11, 52, 12)])
            eng.memnot([(BlockRef("v", 63), BlockRef("k", 0))])

    counters = ops.KERNEL_COUNTERS
    for use_fused in (True, False):
        cpu, gpu = engine("cpu", use_fused), engine("cuda", use_fused)
        script(cpu)
        c0 = {n: c.n for n, c in counters.items()}
        script(gpu)
        torch.cuda.synchronize()
        ran = {n: c.n - c0[n] for n, c in counters.items()}
        for name in cpu.pools:
            np.testing.assert_array_equal(bits(gpu.pools[name]),
                                          bits(cpu.pools[name]), name)
        if use_fused:
            assert gpu.stats.launches == 1
            assert ran["psm_transfer"] == 1 and ran["fused_dispatch"] >= 1
        else:
            assert ran["psm_transfer"] >= 1 and ran["fpm_copy"] >= 1 \
                and ran["zero_init"] >= 1


@pytest.mark.cuda
def test_cuda_mesh_serving_matches_cpu_ranks(card):
    """``ServingEngine(mesh=)`` over 8 ranks of the card ((2, 4) over
    ``("data", "model")``, 2 batch groups) against the same engine over 8
    CPU ranks and the single-device engine on the card, llama3.2-3b at
    full width cut to 2 layers: 3 prompts, a round, a fork, 2 rounds, each
    round fed the CPU engine's greedy tokens.  On the card every round
    drains in at most one ``fused_mesh`` dispatch and launches K2 once per
    rank and layer; the block tables equal the CPU engine's and the logits
    agree within 5e-2 x max |logit| (bf16 GEMMs on two machines); the
    pages that no attention output feeds (every prompt position, and
    layer 0 everywhere) equal the single-device engine's bitwise, moved
    there through K1 and K7.  The CPU and card pools cannot agree bitwise:
    their GEMMs sum in other orders."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.launch.serve import ServingEngine
    from repro_torch.weights import init_params
    cfg = dataclasses.replace(get_config("llama3.2-3b"), num_layers=2)
    cpu_model = init_params(cfg, 0, "cpu")
    card_model = init_params(cfg, 0, "cpu").to("cuda")
    kw = dict(max_seqs=8, max_blocks_per_seq=4, num_slabs=4)
    engines = {
        "cpu": ServingEngine(cfg, cpu_model, mesh=make_test_mesh(
            (2, 4), ("data", "model"), devices="cpu"), **kw),
        "card": ServingEngine(cfg, card_model, mesh=make_test_mesh(
            (2, 4), ("data", "model"), devices="cuda"), **kw),
        "one": ServingEngine(cfg, card_model, device="cuda", **kw)}
    assert engines["card"].cache.batch_groups == 2
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab_size, size=24).astype(np.int32)
               for _ in range(3)]
    sids = {n: [e.add_request(p) for p in prompts]
            for n, e in engines.items()}
    assert sids["cpu"] == sids["card"] == sids["one"]
    mechs = []
    hook = lambda n, p, m: mechs.append(m)
    k2 = ops.KERNEL_COUNTERS["paged_attention"]
    for rnd in range(3):
        if rnd == 1:
            for e in engines.values():
                e.fork(sids["cpu"][0], 1)
        toks = engines["cpu"].decode_round()
        for n in ("card", "one"):
            order = iter([toks[s] for s in sorted(toks)])
            m0, c0 = len(mechs), k2.n
            fd.add_launch_hook(hook)
            try:
                assert engines[n].decode_round(
                    sample_fn=lambda _: next(order)) == toks
            finally:
                fd.remove_launch_hook(hook)
            torch.cuda.synchronize()
            if n == "card":
                assert mechs[m0:] in ([], ["fused_mesh"]), mechs[m0:]
                assert k2.n - c0 == cfg.num_layers * 8
    cpu, card, one = (engines[n] for n in ("cpu", "card", "one"))
    for s in cpu.cache.seqs:
        assert card.cache.blocks_of(s) == cpu.cache.blocks_of(s)
        scale = float(np.abs(cpu.last_logits[s]).max())
        for other in (cpu, one):
            assert float(np.abs(card.last_logits[s]
                                - other.last_logits[s]).max()) \
                <= 5e-2 * scale
        ss = card.engine.num_blocks // 8
        for bm, b1 in zip(card.cache.blocks_of(s), one.cache.blocks_of(s)):
            for name in ("k", "v"):
                got = card.engine.slabs(name)[bm // ss][:, bm % ss]
                want = one.engine.block(name, b1)
                np.testing.assert_array_equal(bits(got[0]), bits(want[0]))
                np.testing.assert_array_equal(bits(got[1, :24]),
                                              bits(want[1, :24]))


@pytest.mark.cuda
def test_cuda_mesh_model_layer_matches_cpu_ranks(card):
    """The model layer over 8 ranks of the card against 8 CPU ranks.
    zamba2-2.7b at full width cut to 2 shared blocks (12 Mamba2 layers),
    4 prompts of 16 tokens over ``(2, 4)`` of ``("data", "model")``:
    ``prefill_state(mesh=)`` and 2 ``decode_state(mesh=)`` steps fed the
    CPU run's greedy tokens, K2 once per rank and shared block a step, the
    slabs' layout equal, logits within 5e-2 x max |logit| (bf16 GEMMs on
    two machines).  Then ``moe_ffn_a2a`` of reduced deepseek-moe-16b with
    its published routing (64 experts, top 6) in fp32 over ``("model",)``
    8: every rank's kept routes equal and the output within 1e-4."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import moe
    from repro_torch.weights import init_params
    full = get_config("zamba2-2.7b")
    cfg = dataclasses.replace(full, num_layers=2 * full.shared_attn_every)
    models = {"cpu": init_params(cfg, 0, "cpu")}
    models["card"] = init_params(cfg, 0, "cpu").to("cuda")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        2, cfg.vocab_size, (4, 16)))
    k2 = ops.KERNEL_COUNTERS["paged_attention"]
    runs = {}
    for name, dev in (("cpu", "cpu"), ("card", "cuda")):
        mesh = make_test_mesh((2, 4), ("data", "model"), devices=dev)
        lg, st = models[name].prefill_state(tokens.to(dev), mesh=mesh)
        runs[name] = [lg.float().cpu()]
        for step in range(2):
            tok = runs["cpu"][step].argmax(-1).to(dev)
            c0 = k2.n
            lg, st = models[name].decode_state(st, tok, mesh=mesh)
            if name == "card":
                assert k2.n - c0 == 2 * 8
            runs[name].append(lg.float().cpu())
        runs[name + " slabs"] = [tuple(s.shape) for s in st["k_pools"]]
    assert runs["card slabs"] == runs["cpu slabs"] and \
        len(runs["cpu slabs"]) == 8
    for a, b in zip(runs["card"], runs["cpu"]):
        assert float((a - b).abs().max()) <= 5e-2 * float(b.abs().max())

    mcfg = dataclasses.replace(get_config("deepseek-moe-16b").reduced(),
                               num_experts=64, top_k=6)
    gen = torch.Generator().manual_seed(0)
    layer = moe.MoEFFN(mcfg, torch.float32, "cpu")
    for p in layer.parameters():
        p.data.copy_(torch.randn(p.shape, generator=gen)
                     * p.shape[-2] ** -0.5)
    x = torch.randn((2, 256, mcfg.d_model), generator=gen)
    routes, ys = {}, {}
    saved = moe.route_local
    for name, dev in (("cpu", "cpu"), ("card", "cuda")):
        calls = routes.setdefault(name, [])

        def record(*args, **kw):
            out = saved(*args, **kw)
            calls.append([t.cpu() for t in out[1:4]])
            return out

        moe.route_local = record
        try:
            ys[name] = moe.moe_ffn_a2a(
                layer.to(dev), x.to(dev), mcfg,
                make_test_mesh((8,), ("model",), devices=dev))[0].cpu()
        finally:
            moe.route_local = saved
    assert len(routes["card"]) == len(routes["cpu"]) == 8
    for a, b in zip(routes["card"], routes["cpu"]):
        assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert not all(bool(r[2].all()) for r in routes["cpu"]), "no drop"
    assert float((ys["card"] - ys["cpu"]).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_cuda_moe_mesh_paths_over_mixed_devices(card):
    """The moe mesh paths with ranks on two devices: a mesh of 8 ranks
    alternating the card and the CPU, the layer and x on the card, against
    the same mesh with every rank on the card.  Reduced deepseek-moe-16b
    (shared experts included) with its published routing (64 experts, top
    6) in fp32: ``moe_ffn_a2a`` over ``("model",)`` 8 (2 x 256 tokens) and
    ``moe_ffn_fsdp`` over ``("data",)`` 8 (8 x 32 tokens) take their path,
    every rank's kept routes are equal, the output within 1e-4 and aux
    within 1e-5."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import moe
    cfg = dataclasses.replace(get_config("deepseek-moe-16b").reduced(),
                              num_experts=64, top_k=6)
    assert cfg.num_shared_experts
    gen = torch.Generator().manual_seed(0)
    layer = moe.MoEFFN(cfg, torch.float32, "cpu")
    for p in layer.parameters():
        p.data.copy_(torch.randn(p.shape, generator=gen)
                     * p.shape[-2] ** -0.5)
    layer.to("cuda")
    saved = moe.route
    for fn, axes, shape in ((moe.moe_ffn_a2a, ("model",), (2, 256)),
                            (moe.moe_ffn_fsdp, ("data",), (8, 32))):
        x = torch.randn(shape + (cfg.d_model,), generator=gen).cuda()
        want = "a2a" if fn is moe.moe_ffn_a2a else "fsdp"
        runs = {}
        for name, devs in (("card", "cuda"), ("mixed", ["cuda", "cpu"] * 4)):
            mesh = make_test_mesh((8,), axes, devices=devs)
            assert moe.moe_path(mesh, x.shape, cfg) == want
            calls = []

            def record(*args, **kw):
                out = saved(*args, **kw)
                calls.append([t.cpu() for t in out[1:4]])
                return out

            moe.route = record
            try:
                y, aux = fn(layer, x, cfg, mesh)
            finally:
                moe.route = saved
            assert y.device == x.device and aux.device == x.device
            runs[name] = (y.cpu(), aux.cpu(), calls)
        (y0, a0, r0), (y1, a1, r1) = runs["card"], runs["mixed"]
        assert len(r0) == len(r1) == 8, want
        for a, b in zip(r0, r1):
            assert all(torch.equal(u, v) for u, v in zip(a, b)), want
        assert float((y1 - y0).abs().max()) <= 1e-4, want
        assert abs(float(a1 - a0)) <= 1e-5, want


# ---------------------------------------------------------------------------
# training (launch/train.py)
# ---------------------------------------------------------------------------

@pytest.mark.cuda
def test_train_full_width_step_fits_the_card(card):
    """One training step of llama3.2-3b at full width and depth (fp32
    masters, grads and moments, bf16 views, B = 2 x S = 1,024): finite,
    its peak allocation under 80 GB."""
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data import make_batch, to_device
    from repro_torch.launch.train import make_train_step, train_state
    from repro_torch.weights import init_params
    cfg = get_config("llama3.2-3b")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = init_params(cfg, 0, "cuda", param_dtype=torch.float32)
    step = make_train_step(model, TrainConfig(total_steps=8, warmup_steps=1))
    state, m = step(train_state(model),
                    to_device(make_batch(cfg, 2, 1024, 0), "cuda"))
    assert np.isfinite(float(m["loss"])) and np.isfinite(
        float(m["grad_norm"]))
    assert torch.cuda.max_memory_allocated() < 80e9
    del model, state, step
    torch.cuda.empty_cache()


@pytest.mark.cuda
def test_train_steps_on_card_match_cpu(card):
    """Three steps of llama3.2-3b reduced from the same fp32 weights on the
    same batches on the card and on the CPU: losses rtol 1e-4, grad_norm
    rtol 1e-2, weights 99.9% within 1e-2 x lr and all within 2 lr a step
    (chip_smoke.py phase 21 (b) gives the reasons)."""
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data import make_batch, to_device
    from repro_torch.launch.train import make_train_step, train_state
    from repro_torch.weights import init_params
    cfg = get_config("llama3.2-3b").reduced()
    out = {}
    for dev in ("cpu", "cuda"):
        model = init_params(cfg, 0, "cpu", param_dtype=torch.float32).to(dev)
        state = train_state(model)
        step = make_train_step(model, TrainConfig(total_steps=8,
                                                  warmup_steps=1))
        ms = []
        for i in range(3):
            state, m = step(state, to_device(make_batch(cfg, 4, 64, i), dev))
            ms.append({k: float(v) for k, v in m.items()})
        out[dev] = (ms, {n: p.detach().cpu() for n, p in
                         state.params.items()})
    (cm, cp), (gm, gp) = out["cpu"], out["cuda"]
    for a, b in zip(gm, cm):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-4)
        assert a["grad_norm"] == pytest.approx(b["grad_norm"], rel=1e-2)
    lr = sum(m["lr"] for m in cm)
    diffs = torch.cat([(gp[n] - cp[n]).abs().reshape(-1) for n in cp])
    assert float(diffs.max()) <= 2 * lr + 1e-6
    assert float((diffs <= 1e-2 * lr + 1e-6).float().mean()) >= 0.999


@pytest.mark.cuda
def test_mesh_train_step_over_mixed_devices(card):
    """Two ``make_train_step`` steps over a (2, 4) mesh whose ranks
    alternate the card and the CPU, against the same mesh with every rank
    on the card: reduced deepseek-moe-16b with its published routing (64
    experts, top 6) under ``"tp"`` (the moe FFN through the all-to-all,
    the attention by heads), the state placed by ``shard_state`` (a block
    an odd rank owns lies on the CPU and is updated there).  Losses rtol
    1e-4, grad_norm rtol 1e-3, weights 99.9% within 1e-2 x lr and all
    within 2 lr a step (phase 21 (b)'s reasons: fp32 products of two
    devices)."""
    import dataclasses
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data import batch_logical_axes, make_batch, to_device
    from repro_torch.launch.mesh import gather, make_test_mesh, pieces
    from repro_torch.launch.train import build_train_step, train_state
    from repro_torch.models import moe
    from repro_torch.weights import init_params, params_axes
    cfg = dataclasses.replace(get_config("deepseek-moe-16b").reduced(),
                              num_experts=64, top_k=6)
    tcfg = TrainConfig(total_steps=8, warmup_steps=1, sharding="tp")
    out = {}
    for name, devs in (("card", "cuda"), ("mixed", ["cuda", "cpu"] * 4)):
        mesh = make_test_mesh((2, 4), ("data", "model"), devices=devs)
        model = init_params(cfg, 0, "cpu", param_dtype=torch.float32)
        step, shard_state, _ = build_train_step(
            model, tcfg, mesh, params_axes(model), batch_logical_axes(cfg))
        state = train_state(model, shard_state(dict(
            model.named_parameters())))
        placed = {t.device.type for p in state.params.values()
                  for t in pieces(p)}
        assert placed == {d.type for d in mesh.devices}, placed
        moe.PATH_COUNTS.clear()
        ms = []
        for i in range(2):
            state, m = step(state, to_device(make_batch(cfg, 2, 64, i),
                                             "cuda"))
            ms.append({k: float(v) for k, v in m.items()})
        assert dict(moe.PATH_COUNTS) == {"a2a": 2 * cfg.num_layers}
        out[name] = (ms, {n: gather(p, "cpu").detach()
                          for n, p in state.params.items()})
    (cm, cp), (xm, xp) = out["card"], out["mixed"]
    for a, b in zip(xm, cm):
        assert a["loss"] == pytest.approx(b["loss"], rel=1e-4)
        assert a["grad_norm"] == pytest.approx(b["grad_norm"], rel=1e-3)
    lr = sum(m["lr"] for m in cm)
    diffs = torch.cat([(xp[n] - cp[n]).abs().reshape(-1) for n in cp])
    assert float(diffs.max()) <= 2 * lr + 1e-6
    assert float((diffs <= 1e-2 * lr + 1e-6).float().mean()) >= 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3.2-3b", "deepseek-moe-16b",
                                  "paligemma-3b", "mamba2-780m",
                                  "zamba2-2.7b", "seamless-m4t-medium"])
def test_training_launches_no_kernel(card, arch):
    """A training step of each family on the card launches none of K1-K7
    (the reference trains through no Pallas kernel), and its loss is
    finite."""
    from repro_torch.configs import TrainConfig, get_config
    from repro_torch.data import make_batch, to_device
    from repro_torch.launch.train import make_train_step, train_state
    from repro_torch.weights import init_params
    cfg = get_config(arch).reduced()
    model = init_params(cfg, 0, "cuda", param_dtype=torch.float32)
    step = make_train_step(model, TrainConfig(total_steps=4, warmup_steps=1))
    counters = ops.KERNEL_COUNTERS
    c0 = {n: c.n for n, c in counters.items()}
    _, m = step(train_state(model),
                to_device(make_batch(cfg, 2, 64, 0), "cuda"))
    torch.cuda.synchronize()
    assert {n: c.n - c0[n] for n, c in counters.items()} == \
        {n: 0 for n in counters}
    assert np.isfinite(float(m["loss"]))
