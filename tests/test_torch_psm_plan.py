"""K7's host plan (``kernels/psm_transfer.py plan_rows``, the Python
statement of what ``csrc/psm_transfer.cu`` does before its launch) on the
CPU:

* against the contract, :func:`check_rows`, on seeded random calls over
  n in {1, 2, 4, 8} ranks, one to three tables, shared slabs, skip rows
  (``rank_rows``) and rows outside the call, WAW and RAW rows: the same
  calls accepted, the same first offending row refused with the same
  message, the kept rows resolved to the blocks the contract names;
* its split of a call by source card;
* its route, chunking and launch parameters' layout (rows under and over
  the parameters' room, aligned and unaligned pages, a base 8 bytes off);
* its launch rows, moved byte for byte as the kernel moves them, against
  the reference's global PSM (``_psm_jit`` on ids ``rank * slab +
  local``).

The library's plan is held against :func:`plan_rows` on the card
(``chip_smoke.py`` phase 20).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.rowclone import _psm_jit
from repro_torch.kernels import fpm_copy as tfpm
from repro_torch.kernels import psm_transfer as k7

#: an SM count for the plan's grid (an H100's)
SMS = 132
#: the block of the random calls: (2, 4) float32, 3 layers on block axis 1
BLOCK, LAYERS = (2, 4), 3
PAGE = 2 * 4 * 4

ROW_DTYPE = np.dtype([("src", "<i8"), ("dst", "<i8"), ("src_nblk", "<i4"),
                      ("dst_nblk", "<i4")])


def records(tables, block_axis, cards=None):
    """The slab records the wrapper packs: (address, blocks, card) per
    (table, side, rank); ``cards`` maps a tensor's ``id`` to its card."""
    cards = cards or {}
    return np.array([(t.data_ptr(), t.shape[block_axis], cards.get(id(t), 0))
                     for table in tables for side in table for t in side],
                    np.int64)


def gen_call(rng, n, block_axis):
    """A random call: one to three tables over a few slab tensors (shared
    between tables and sides), rows drawn in range or as ``rank_rows`` of
    per-rank ids with skip rows, then perhaps one row pushed outside the
    call, a copied destination (WAW) or a source on another row's
    destination (RAW)."""
    ba = block_axis

    def slab(nb):
        shape = (nb,) + BLOCK if ba == 0 else (LAYERS, nb) + BLOCK
        return torch.zeros(shape)

    pool = [slab(int(rng.integers(2, 24))) for _ in range(
        int(rng.integers(1, 2 * n + 2)))]
    nt = int(rng.integers(1, 4))
    tables = []
    for _ in range(nt):
        src = [pool[i] for i in rng.integers(0, len(pool), n)]
        dst = src if rng.random() < 0.4 else \
            [pool[i] for i in rng.integers(0, len(pool), n)]
        tables.append((src, dst))

    def nblk(t, side, r):
        return int(tables[t][side][r].shape[ba])

    m = int(rng.integers(0, 2 * n + 3))
    if rng.random() < 0.3:
        tab = int(rng.integers(nt))
        ids = np.full((n, m, 3), -1, np.int64)
        for my in range(n):
            for j in range(m):
                if rng.random() < 0.3:
                    continue                              # a skip row
                hop = int(rng.integers(-(n - 1), n))
                tgt = (my + hop + n) % n
                ids[my, j] = (rng.integers(nblk(tab, 0, my)),
                              rng.integers(nblk(tab, 1, tgt)), hop)
        rows = k7.rank_rows(ids, n, table=tab)
    else:
        rows = []
        for _ in range(m):
            tab, my = int(rng.integers(nt)), int(rng.integers(n))
            hop = int(rng.integers(-(n - 1), n))
            tgt = (my + hop + n) % n
            rows.append([tab, my, int(rng.integers(nblk(tab, 0, my))),
                         int(rng.integers(nblk(tab, 1, tgt))), hop])
        rows = np.asarray(rows, np.int64).reshape(-1, 5)
    if len(rows):
        i, j = rng.integers(len(rows), size=2)
        what = rng.random()
        if what < 0.15:
            field = int(rng.integers(5))
            rows[i, field] = {0: (-1, nt), 1: (-1, n), 2: (-1, 99),
                              3: (-1, 99), 4: (-n, n)}[field][
                                  int(rng.integers(2))]
        elif what < 0.3:
            rows[j] = rows[i]
            rows[j, 2] = int(rng.integers(2))
        elif what < 0.45:
            t, my, _, d, hop = (int(x) for x in rows[i])
            tgt = (my + hop + n) % n
            rows[j] = (t, tgt, d, rng.integers(nblk(t, 1, tgt)), 0)
    return tables, rows


def contract(tables, rows, ba):
    """``("ok", rows)`` or ``("refused", message)`` from check_rows."""
    try:
        return "ok", k7.check_rows(tables, rows, ba)
    except ValueError as e:
        return "refused", str(e)


def expected_launch_rows(tables, rows, ba):
    out = []
    for t, my, s, d, hop in rows.tolist():
        n = len(tables[t][0])
        src, dst = tables[t][0][my], tables[t][1][(my + hop + n) % n]
        out.append((src.data_ptr() + s * PAGE, dst.data_ptr() + d * PAGE,
                    src.shape[ba] | (dst.shape[ba] << 32)))
    return np.asarray(out, np.int64).reshape(-1, 3)


@pytest.mark.parametrize("block_axis", [0, 1])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_plan_rows_refuses_and_keeps_what_check_rows_does(n, block_axis):
    rng = np.random.default_rng(1000 * n + block_axis)
    seen = {"ok": 0, "refused": 0}
    layers = LAYERS if block_axis else 1
    for _ in range(80):
        tables, rows = gen_call(rng, n, block_axis)
        want, what = contract(tables, rows, block_axis)
        code, kept, out = k7.plan_rows(
            records(tables, block_axis), n, rows, 0, layers=layers,
            page_bytes=PAGE, sms=SMS)
        seen[want] += 1
        if want == "refused":
            assert code < 0
            r = np.asarray(rows, np.int64).reshape(-1, 5)
            got = str(k7.refusal(code, r, int(out[8]), int(out[9]),
                                 len(tables), n))
            assert got == what
            assert len(kept) == 0
        else:
            assert code == 0, str(k7.refusal(code, rows, int(out[8]),
                                             int(out[9]), len(tables), n))
            np.testing.assert_array_equal(
                kept, expected_launch_rows(tables, what, block_axis))
            assert out[0] == len(what)
    assert seen["ok"] >= 10 and seen["refused"] >= 10, seen


def test_plan_rows_refusal_kinds_and_the_allowed_self_read():
    """Each refusal of ``tests/test_torch_mesh.py``'s contract test, from
    the plan with check_rows's message; a row reading the block it writes
    is kept."""
    slabs = [torch.zeros((4, 2, 3)) for _ in range(4)]
    t = [(slabs, slabs)]
    rec = records(t, 0)
    cases = [[[0, 0, 1, 2, 4]], [[0, 5, 1, 2, 1]], [[0, 0, 4, 2, 1]],
             [[1, 0, 1, 2, 1]], [[0, 0, 1, 2, 1], [0, 2, 3, 2, -1]],
             [[0, 0, 1, 2, 1], [0, 1, 2, 3, 1]]]
    codes = [k7.OUTSIDE] * 2 + [k7.BLOCK_OUTSIDE, k7.OUTSIDE, k7.WAW, k7.RAW]
    for rows, want in zip(cases, codes):
        r = np.asarray(rows, np.int64)
        code, _, out = k7.plan_rows(rec, 4, r, 0, layers=1, page_bytes=24,
                                    sms=SMS)
        assert code == want
        with pytest.raises(ValueError) as ei:
            k7.check_rows(t, r, 0)
        assert str(k7.refusal(code, r, int(out[8]), int(out[9]), 1, 4)) == \
            str(ei.value)
    code, kept, _ = k7.plan_rows(rec, 4, [[0, 1, 2, 2, 0]], 0, layers=1,
                                 page_bytes=24, sms=SMS)
    assert code == 0 and len(kept) == 1 and kept[0, 0] == kept[0, 1]


def test_plan_rows_splits_a_call_by_source_card():
    """Rank r's slabs on card r: each card keeps the rows whose source
    slab it holds, in row order; every card refuses a refused call the
    same way (no card launches)."""
    n, nblk, page = 4, 64, 4096
    rng = np.random.default_rng(5)
    base = 1 << 40
    rec = np.array([(base + (side * n + r) * nblk * page, nblk, r)
                    for side in (0, 1) for r in range(n)], np.int64)
    rows = np.array([[0, i % n, i, 32 + i, int(rng.integers(-(n - 1), n))]
                     for i in range(24)], np.int64)
    parts = []
    for c in range(n):
        code, kept, out = k7.plan_rows(rec, n, rows, c, layers=1,
                                       page_bytes=page, sms=SMS)
        assert code == 0 and out[0] == (rows[:, 1] == c).sum()
        assert ((kept[:, 0] - base) // (nblk * page) == c).all()
        parts.append(kept)
    whole = np.concatenate(parts)
    one = rec.copy()
    one[:, 2] = 0
    _, every, _ = k7.plan_rows(one, n, rows, 0, layers=1, page_bytes=page,
                               sms=SMS)
    assert sorted(map(tuple, whole.tolist())) == \
        sorted(map(tuple, every.tolist()))
    bad = rows.copy()
    bad[5, 3] = bad[2, 3]
    bad[5, 4] = bad[2, 4]
    bad[5, 1] = bad[2, 1]
    for c in range(n):
        code, kept, out = k7.plan_rows(rec, n, bad, c, layers=1,
                                       page_bytes=page, sms=SMS)
        assert (code, len(kept), int(out[8])) == (k7.WAW, 0, 5)


def layout_call(n, n_rows, base_off=0, nblk=512):
    """Records of n ranks' slabs (sources then destinations) at aligned
    fake addresses (``base_off`` added to rank 0's source) and rows
    ``[0, i % n, i, 256 + i, hop]``: one writer a block, no RAW."""
    span = 1 << 36
    rec = np.array([((1 << 44) + (side * n + r) * span
                     + (base_off if side == r == 0 else 0), nblk, 0)
                    for side in (0, 1) for r in range(n)], np.int64)
    rows = np.array([[0, i % n, i, 256 + i, (i % (2 * n - 1)) - (n - 1)]
                     for i in range(n_rows)], np.int64)
    return rec, rows


@pytest.mark.parametrize("case,n,n_rows,layers,page,base_off,want", [
    # (chunk, chunks per page, items, grid, bulk, word, through the buffer)
    ("n = 8 at full width", 8, 101, 28, 131072, 0,
     (32768, 4, 11312, 132, 1, 16, 0)),
    ("n = 4 at full width", 4, 22, 28, 131072, 0,
     (32768, 4, 2464, 132, 1, 16, 0)),
    ("over the parameters' room", 8, 200, 1, 131072, 0,
     (32768, 4, 800, 132, 1, 16, 1)),
    ("at the parameters' room", 8, 169, 1, 131072, 0,
     (32768, 4, 676, 132, 1, 16, 0)),
    ("unaligned page", 4, 10, 3, 102, 0, (102, 1, 30, 30, 0, 2, 0)),
    ("a base 8 bytes off", 4, 10, 28, 131072, 8,
     (32768, 4, 1120, 1056, 0, 8, 0)),
])
def test_plan_layout(case, n, n_rows, layers, page, base_off, want):
    """The route, the chunking (K5's, with a ring of STAGES chunks a CTA
    on the bulk route: 4-32 KiB aiming at 2 items per SM, one CTA an SM at
    32 KiB; 32 KiB chunks and 8 CTAs an SM on the word loop) and the
    launch rows as csrc/psm_transfer.cu lays them out: 24-byte ``Row``s,
    the blocks' page-0 addresses and the slabs' block counts, in the
    launch parameters up to ROW_CAPACITY rows, else in the buffer."""
    rec, rows = layout_call(n, n_rows, base_off)
    code, kept, out = k7.plan_rows(rec, n, rows, 0, layers=layers,
                                   page_bytes=page, sms=SMS)
    assert code == 0
    chunk, cpp, items, grid, bulk, word, buf = want
    assert out[:8].tolist() == [n_rows, items, grid, chunk, cpp, bulk, word,
                                buf]
    assert (chunk, cpp, items, grid) == tfpm.chunking(
        n_rows, layers, page, bulk=bool(bulk), zero=False, sms=SMS,
        buffers=k7.STAGES)
    view = np.ascontiguousarray(kept).view(ROW_DTYPE).reshape(-1)
    assert kept.dtype == np.int64 and kept.nbytes == n_rows * k7.ROW_BYTES
    tgt = (rows[:, 1] + rows[:, 4] + n) % n
    np.testing.assert_array_equal(
        view["src"], rec[rows[:, 1], 0] + rows[:, 2] * page)
    np.testing.assert_array_equal(
        view["dst"], rec[n + tgt, 0] + rows[:, 3] * page)
    assert (view["src_nblk"] == 512).all() and (view["dst_nblk"] == 512).all()
    assert k7.PARAM_BYTES == 4096


def move_like_the_kernel(buf: np.ndarray, kept, layers, page):
    """The kernel's bytes on a flat byte buffer whose offsets are the
    addresses: every (row, layer) page read, then written."""
    pages = []
    for src, dst, nb in kept.tolist():
        sn, dn = nb & 0xFFFFFFFF, nb >> 32
        for layer in range(layers):
            pages.append((dst + layer * dn * page,
                          buf[src + layer * sn * page:
                              src + layer * sn * page + page].copy()))
    for at, b in pages:
        buf[at:at + page] = b


@pytest.mark.parametrize("n,block_axis", [(2, 0), (4, 0), (8, 0), (4, 1)])
def test_plan_rows_moves_what_the_reference_moves(n, block_axis):
    """The plan's launch rows, moved as the kernel moves them over slabs
    laid end to end in one buffer, equal the reference's global PSM on the
    whole pool (``_psm_jit``; numpy's gather / scatter on a layer-stacked
    pool) for rows at every hop, with skip rows."""
    ss, blk = 32, (4, 16)
    page = 4 * 16 * 4
    rng = np.random.default_rng(n + 10 * block_axis)
    shape = (ss * n,) + blk if block_axis == 0 else (LAYERS, ss * n) + blk
    pool = rng.standard_normal(shape).astype(np.float32)
    ids = np.full((n, 2 * n - 1, 3), -1, np.int64)
    free = {r: list(rng.permutation(np.arange(ss // 2, ss)))
            for r in range(n)}
    for my in range(n):
        for j, hop in enumerate(range(-(n - 1), n)):
            if rng.random() < 0.2:
                continue                                 # a skip row
            ids[my, j] = (rng.integers(0, ss // 2),
                          free[(my + hop + n) % n].pop(), hop)
    glob = [(my * ss + s, ((my + hop + n) % n) * ss + d)
            for my in range(n)
            for s, d, hop in ids[my][ids[my, :, 0] >= 0].tolist()]
    g = np.asarray(glob, np.int32)
    if block_axis == 0:
        want = np.array(_psm_jit(jnp.asarray(pool), jnp.asarray(g)))
    else:
        want = pool.copy()
        want[:, g[:, 1]] = pool[:, g[:, 0]]
    slabs = np.split(pool, n, axis=block_axis)
    size = slabs[0].nbytes
    buf = np.concatenate([np.ascontiguousarray(s).view(np.uint8).reshape(-1)
                          for s in slabs])
    rec = np.array([(r * size, ss, 0) for _ in (0, 1) for r in range(n)],
                   np.int64)
    layers = LAYERS if block_axis else 1
    code, kept, out = k7.plan_rows(rec, n, k7.rank_rows(ids, n), 0,
                                   layers=layers, page_bytes=page, sms=SMS)
    assert code == 0 and out[0] == len(g)
    move_like_the_kernel(buf, kept, layers, page)
    got = np.concatenate(
        [buf[r * size:(r + 1) * size].view(np.float32).reshape(slabs[0].shape)
         for r in range(n)], axis=block_axis)
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
