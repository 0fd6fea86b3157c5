"""The plain versions of K5a (FPM copy), K5b (pool-to-pool copy) and K6
(BuZ zero-init) against the JAX package, bitwise, and the host wave
schedule that orders K5's pairs on the GPU.

* block axis 0: the Pallas kernels run in interpret mode
  (``fpm_copy_pallas``, ``fpm_copy_cross_pallas``, ``zero_init_pallas``)
  over the dtypes and block shapes of ``tests/test_kernels.py``, with
  ``-1`` padding and an in-call write-after-read pair, plus a hypothesis
  property; ``baseline_copy`` against ``repro.kernels.ref``;
* block axis 1: the jnp helpers of the JAX fan-out (``_fpm_axis1_jit``,
  ``_cross_axis1_jit``, ``_zero_axis1_jit``, ``_baseline_axis1_jit``);
* the GPU runs a call's pairs concurrently, so :func:`pair_waves` must put
  every writer after each earlier reader of its block: pairs run wave by
  wave, in a shuffled order inside each wave, one at a time, equal the
  gather-then-scatter result.
"""
import random

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hypo import given, settings, st
from test_torch_contract import bits, to_torch

from repro.core import rowclone as jrc
from repro.kernels import ref as jref
from repro.kernels.fpm_copy import fpm_copy_cross_pallas, fpm_copy_pallas
from repro.kernels.zero_init import zero_init_pallas
from repro_torch.kernels import ops, ref
from repro_torch.kernels import fpm_copy as tfpm
from repro_torch.kernels.fpm_copy import pair_waves

DTYPES = [np.float32, jnp.bfloat16, np.int32]
BLOCK_SHAPES = [(8, 128), (16, 4, 64), (128,)]
#: [src, dst] rows: padding, and a write-after-read pair (row 4 rewrites
#: row 0's source)
IDS = np.array([[0, 5], [3, 7], [2, -1], [1, 9], [6, 0]], np.int32)
ZIDS = np.array([4, -1, 11, 2], np.int32)


def make_pool(seed, shape, dtype):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape) * 10).astype(np.float32).astype(dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("block_shape", BLOCK_SHAPES)
def test_fpm_copy_matches_pallas(dtype, block_shape):
    pool = make_pool(0, (16,) + block_shape, dtype)
    want = fpm_copy_pallas(jnp.asarray(pool), jnp.asarray(IDS),
                           interpret=True)
    got = ref.fpm_copy(to_torch(pool), IDS)
    np.testing.assert_array_equal(bits(got), bits(want))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("block_shape", BLOCK_SHAPES)
def test_fpm_copy_cross_matches_pallas(dtype, block_shape):
    src = make_pool(1, (8,) + block_shape, dtype)
    dst = make_pool(2, (12,) + block_shape, dtype)
    ids = np.array([[0, 3], [7, 11], [2, -1], [5, 0]], np.int32)
    want = fpm_copy_cross_pallas(jnp.asarray(dst), jnp.asarray(src),
                                 jnp.asarray(ids), interpret=True)
    got = ref.fpm_copy_cross(to_torch(dst), to_torch(src), ids)
    np.testing.assert_array_equal(bits(got), bits(want))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("block_shape", BLOCK_SHAPES)
def test_zero_init_matches_pallas(dtype, block_shape):
    pool = make_pool(3, (16,) + block_shape, dtype)
    zero_block = jnp.zeros((1,) + block_shape, pool.dtype)
    want = zero_init_pallas(jnp.asarray(pool), zero_block,
                            jnp.asarray(ZIDS), interpret=True)
    got = ref.zero_init(to_torch(pool), ZIDS)
    np.testing.assert_array_equal(bits(got), bits(want))


@pytest.mark.parametrize("dtype", DTYPES)
def test_baseline_copy_matches_reference(dtype):
    pool = make_pool(4, (16, 8, 128), dtype)
    want = jref.baseline_copy(jnp.asarray(pool), jnp.asarray(IDS[:, 0]),
                              jnp.asarray(IDS[:, 1]))
    got = ops.baseline_copy(to_torch(pool), IDS)
    np.testing.assert_array_equal(bits(got), bits(want))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind", ["fpm", "cross", "zero", "baseline"])
def test_axis1_matches_jax_fanout_helpers(dtype, kind):
    """Layer-stacked pools (L, nblk, ...): a block is L strided pages; the
    ids must index axis 1 (ids above L catch an axis-0 mix-up)."""
    pool = make_pool(5, (3, 16, 4, 8), dtype)
    ids = np.array([[0, 12], [9, 3], [2, -1], [14, 0]], np.int32)
    if kind == "fpm":
        want = jrc._fpm_axis1_jit(jnp.asarray(pool), jnp.asarray(ids))
        got = ops.fpm_copy(to_torch(pool), ids, block_axis=1)
    elif kind == "baseline":
        want = jrc._baseline_axis1_jit(jnp.asarray(pool), jnp.asarray(ids))
        got = ops.baseline_copy(to_torch(pool), ids, block_axis=1)
    elif kind == "zero":
        want = jrc._zero_axis1_jit(jnp.asarray(pool), jnp.asarray(ZIDS))
        got = ops.meminit_zero(to_torch(pool), ZIDS, block_axis=1)
    else:
        src = make_pool(6, (3, 20, 4, 8), dtype)
        want = jrc._cross_axis1_jit(jnp.asarray(pool), jnp.asarray(src),
                                    jnp.asarray(ids))
        got = ops.fpm_copy_cross(to_torch(pool), to_torch(src), ids,
                                 block_axis=1)
    np.testing.assert_array_equal(bits(got), bits(want))


@settings(max_examples=25, deadline=None)
@given(st.data())
def test_copy_and_zero_property(data):
    """The engine contract of ``tests/test_kernels.py``: destinations are
    disjoint from sources and from each other, padding anywhere; the plain
    versions equal the interpreted Pallas kernels."""
    nblk = data.draw(st.integers(8, 32))
    half = nblk // 2
    m = data.draw(st.integers(1, min(half, 8)))
    srcs = data.draw(st.lists(st.integers(0, half - 1), min_size=m,
                              max_size=m))
    dsts = data.draw(st.lists(st.integers(half, nblk - 1), min_size=m,
                              max_size=m, unique=True))
    pad = data.draw(st.lists(st.booleans(), min_size=m, max_size=m))
    dsts = [-1 if p else d for p, d in zip(pad, dsts)]
    ids = np.stack([srcs, dsts], 1).astype(np.int32)
    pool = np.arange(nblk * 8, dtype=np.float32).reshape(nblk, 8)
    want = fpm_copy_pallas(jnp.asarray(pool), jnp.asarray(ids),
                           interpret=True)
    np.testing.assert_array_equal(
        ref.fpm_copy(to_torch(pool), ids).numpy(), np.asarray(want))
    other = -pool[:half]
    want = fpm_copy_cross_pallas(jnp.asarray(pool), jnp.asarray(other),
                                 jnp.asarray(ids), interpret=True)
    np.testing.assert_array_equal(
        ref.fpm_copy_cross(to_torch(pool), to_torch(other), ids).numpy(),
        np.asarray(want))
    zids = np.asarray(dsts, np.int32)
    want = zero_init_pallas(jnp.asarray(pool), jnp.zeros((1, 8)),
                            jnp.asarray(zids), interpret=True)
    np.testing.assert_array_equal(ref.zero_init(to_torch(pool), zids).numpy(),
                                  np.asarray(want))


# ---------------------------------------------------------------------------
# the wave schedule of K5
# ---------------------------------------------------------------------------

def gen_pairs(rng, nblk, n):
    """Random ``(src, dst)`` pairs with write-after-read pairs, adjacent or
    not, and self-copies, but no RAW or WAW (the queue's guarantee)."""
    pairs, written = [], set()
    for _ in range(50 * n):
        if len(pairs) >= n:
            break
        s, d = rng.randrange(nblk), rng.randrange(nblk)
        if rng.random() < 0.4 and pairs:      # rewrite an earlier source
            d = rng.choice(pairs)[0]
        if s in written or d in written:
            continue
        pairs.append((s, d))
        written.add(d)
    return pairs


@pytest.mark.parametrize("seed", range(8))
def test_pair_waves_order_equals_gather_then_scatter(seed):
    rng = random.Random(seed)
    nblk = 24
    pairs = gen_pairs(rng, nblk, 14)
    waves = pair_waves(pairs)
    pool = torch.from_numpy(make_pool(seed, (nblk, 4), np.float32))
    want = ref.fpm_copy(pool.clone(), pairs)
    got = pool.clone()
    for w in range(max(waves) + 1):
        idx = [i for i, x in enumerate(waves) if x == w]
        rng.shuffle(idx)
        for i in idx:
            ref.fpm_copy(got, [pairs[i]])
    np.testing.assert_array_equal(got.numpy(), want.numpy())


def loop_waves(pairs):
    """The wave rule written as a plain loop: raises on RAW / WAW."""
    last_read, written, waves = {}, set(), []
    for s, d in pairs:
        if s in written:
            raise ValueError("RAW")
        if d in written:
            raise ValueError("WAW")
        waves.append(last_read.get(d, -1) + 1)
        if s != d:
            last_read[s] = max(last_read.get(s, 0), waves[-1])
        written.add(d)
    return waves


@pytest.mark.parametrize("seed", range(6))
def test_pair_waves_matches_a_plain_loop(seed):
    """The vectorised schedule equals the loop on random pair lists, RAW
    and WAW lists included (both raise)."""
    rng = random.Random(seed)
    for _ in range(200):
        n = rng.randint(1, 12)
        pairs = [(rng.randrange(16), rng.randrange(16)) for _ in range(n)]
        if rng.random() < 0.5:
            pairs = gen_pairs(rng, 16, n)
        try:
            want = loop_waves(pairs)
        except ValueError:
            with pytest.raises(ValueError):
                pair_waves(pairs)
            continue
        assert pair_waves(pairs).tolist() == want, pairs


def test_pair_waves_teeth():
    """A WAR pair lands in a later wave, and running the pairs in the
    reverse order (what unordered CTAs may do) gives another pool."""
    pairs = [(3, 8), (5, 9), (10, 3)]
    assert pair_waves(pairs).tolist() == [0, 0, 1]
    pool = torch.arange(12.0)[:, None].repeat(1, 4)
    want = ref.fpm_copy(pool.clone(), pairs)
    rev = pool.clone()
    for p in reversed(pairs):
        ref.fpm_copy(rev, [p])
    assert not torch.equal(rev, want)


def test_pair_waves_refuse_raw_and_waw():
    with pytest.raises(ValueError, match="RAW"):
        pair_waves([(1, 2), (2, 3)])
    with pytest.raises(ValueError, match="WAW"):
        pair_waves([(1, 2), (4, 2)])
    # across pools a source cannot clash with a destination
    assert pair_waves([(1, 2), (2, 3)], same_pool=False).tolist() == [0, 0]
    with pytest.raises(ValueError, match="WAW"):
        pair_waves([(1, 2), (4, 2)], same_pool=False)


@pytest.mark.parametrize("pairs,waves,bulk_plan", [
    ([(3, 8), (5, 9), (7, 1)], [0, 0, 0], (4096, 20, 180, 180)),
    # a WAR chain, and a wave-0 row after it: sorting moves that row up
    ([(3, 8), (5, 9), (10, 3), (4, 10), (6, 7)], [0, 0, 1, 2, 0],
     (4560, 18, 270, 270)),
])
def test_block_descriptor_words(pairs, waves, bulk_plan):
    """The launch parameters as csrc/block_move.cuh lays them out: the
    rows ``[src, dst, first row of its wave]`` sorted by wave (stable), and
    the chunking of 3-layer pages of 80 KiB over 132 SMs: the bulk path
    aims at 2 items per SM in even 16-byte multiples of 4-32 KiB, the word
    path moves 32 KiB chunks."""
    rows = np.asarray(pairs, np.int64)
    w = pair_waves(rows)
    assert w.tolist() == waves
    got = tfpm.launch_rows(rows, w)
    assert got.dtype == np.int32 and got.shape == (len(pairs), 3)
    order = sorted(range(len(pairs)), key=lambda i: waves[i])
    assert got[:, :2].tolist() == [list(pairs[i]) for i in order]
    sorted_waves = [waves[i] for i in order]
    assert got[:, 2].tolist() == [sorted_waves.index(x)
                                  for x in sorted_waves]
    layers, page, sms, n = 3, 80 * 1024, 132, len(pairs)
    chunk, cpp, items, grid = tfpm.chunking(n, layers, page, bulk=True,
                                            zero=False, sms=sms)
    assert (chunk, cpp, items, grid) == bulk_plan
    assert chunk % 16 == 0 and (cpp - 1) * chunk < page <= cpp * chunk
    assert tfpm.MIN_CHUNK <= chunk <= tfpm.MAX_CHUNK
    # K6's one tile per CTA leaves room for more CTAs, up to the cap
    assert tfpm.chunking(n, layers, page, bulk=True, zero=True,
                         sms=sms) == bulk_plan
    assert tfpm.chunking(n, layers, page, bulk=False, zero=False,
                         sms=sms) == (32768, 3, 9 * n, 9 * n)
    # small pages: one chunk per page, 16-byte multiples kept
    assert tfpm.chunking(n, 1, 4 * 8 * 4, bulk=True, zero=False,
                         sms=sms)[:3] == (128, 1, n)
    assert len(pairs) <= tfpm.ROW_CAPACITY


def test_fanout_passes_host_ids_to_the_block_moves(monkeypatch):
    """The engine's fan-out hands K5a / K5b / K6 numpy ids, so their
    wrappers schedule on the host without a device sync."""
    from repro_torch.core.allocator import SubarrayAllocator
    from repro_torch.core.rowclone import RowCloneEngine
    from repro_torch.launch import mechanisms
    seen = []
    for name in ("fpm_copy", "fpm_copy_cross", "meminit_zero"):
        real = getattr(ops, name)

        def spy(*args, _real=real, _name=name, **kw):
            ids = args[2] if _name == "fpm_copy_cross" else args[1]
            seen.append((_name, type(ids)))
            return _real(*args, **kw)
        monkeypatch.setattr(ops, name, spy)
    nblk = 2560
    pools = {n: torch.zeros((nblk, 4), dtype=torch.float32)
             for n in ("k", "v")}
    pools.update({n: torch.zeros((64, 4), dtype=torch.float32)
                  for n in ("k_stage", "v_stage")})
    eng = RowCloneEngine(pools, SubarrayAllocator(nblk, 4), use_fused=False,
                         staging={"k_stage": "k", "v_stage": "v"})
    mechanisms.drive(eng, mechanisms.ab_program(nblk))
    assert {n for n, _ in seen} == {"fpm_copy", "fpm_copy_cross",
                                    "meminit_zero"}
    assert all(t is np.ndarray for _, t in seen), seen


def test_kernel_request_on_cpu_tensor_raises():
    pool = torch.zeros((4, 16))
    for call in (lambda: ops.fpm_copy(pool, IDS[:1], use_kernel=True),
                 lambda: ops.fpm_copy_cross(pool, pool, IDS[:1],
                                            use_kernel=True),
                 lambda: ops.meminit_zero(pool, ZIDS[:1], use_kernel=True)):
        with pytest.raises(ValueError):
            call()
    before = {n: c.n for n, c in ops.KERNEL_COUNTERS.items()}
    ops.fpm_copy(pool, [[0, 1]])
    ops.meminit_zero(pool, [2])
    assert {n: c.n for n, c in ops.KERNEL_COUNTERS.items()} == before
