"""The port's plain fused drain (the CUDA K1's plain version) against the
JAX package, bitwise, and the host wave schedule that orders K1's rows.

* random tables over every opcode (AND/OR/NOT included), ``block_axis`` 0
  and 1, unequal pool sizes and staging role vectors: the plain drain is
  bitwise equal (raw-byte views) to ``repro.kernels.ref.fused_dispatch``,
  and on contract tables to ``fused_dispatch_pallas(interpret=True)``;
* the GPU drain runs rows concurrently, so :func:`wave_schedule` must put
  every write-after-read writer after every earlier reader of its block:
  rows run wave by wave, in a shuffled order inside each wave, one row at a
  time through the plain drain, equal the reference on tables with
  non-adjacent WAR pairs;
* the Python statement of K1's plan (:func:`plan_moves`, :func:`chunking`):
  its moves and gates follow :func:`wave_schedule`, running them wave by
  wave (every read of a wave gathered, then scattered, as the kernel's
  gate orders them) equals the reference and the TPU kernel body, RAW and
  WAW tables are refused with the schedule's messages, and the chunking
  of 128 KiB and unaligned pages;
* the plain drain on unaligned block shapes (float32 ``(3,)``, bf16
  ``(5,)``) against the jnp oracle.
"""
import random

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from test_torch_contract import bits, to_torch

from repro.kernels import ref as jref
from repro.kernels.fused_dispatch import fused_dispatch_pallas
from repro_torch.core.opcodes import keys_clash, row_rw
from repro_torch.kernels import fused_dispatch as fd
from repro_torch.kernels import ops, ref
from repro_torch.kernels.fused_dispatch import wave_schedule

LAYOUTS = {
    "twins": ([12, 12], (True, True)),
    "ring": ([16, 16, 4, 4], (True, True, False, False)),
    "ragged": ([8, 8, 5, 3], (True, True, False, False)),
}


def gen_table(rng, sizes, primary, n_rows, contract):
    """Random ``[op, src, dst]`` rows.  Never two writes of one block (the
    reference scatter leaves that order undefined); with ``contract`` also
    no read of a block an earlier row wrote (the queue's guarantee)."""
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
        if contract and any(keys_clash(r, x, primary)
                            for r in reads for x in written):
            continue
        rows.append((op, s, d))
        written.extend(writes)
    return np.asarray(rows, np.int32)


def make_pools(rng_np, sizes, block_axis, dtype):
    L = 3
    out = []
    for n in sizes:
        shape = (n, 4, 8) if block_axis == 0 else (L, n, 4, 8)
        out.append(rng_np.standard_normal(shape).astype(np.float32)
                   .astype(dtype))
    return out


def zero_blocks_np(pools, block_axis):
    return [np.zeros((1,) + p.shape[block_axis + 1:], p.dtype)
            for p in pools]


def assert_same_bits(want, got):
    """Raw-byte equality.  One exception, for bf16 only: XLA on the CPU
    rewrites a bf16 NaN produced by AND/OR into the canonical 0xffc0 inside
    ``jnp.where``, while the port (like the TPU kernel's DMAs) keeps the
    bits; such elements must be NaN on both sides and match elsewhere."""
    for i, (w, g) in enumerate(zip(want, got)):
        w = np.asarray(w)
        if w.dtype == ml_dtypes.bfloat16:
            g_np = g.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
            nan = np.isnan(w.astype(np.float32))
            assert (np.isnan(g_np.astype(np.float32)) == nan).all(), i
            np.testing.assert_array_equal(
                w.view(np.uint16)[~nan], g_np.view(np.uint16)[~nan],
                err_msg=f"pool {i}")
        else:
            np.testing.assert_array_equal(bits(w), bits(g),
                                          err_msg=f"pool {i}")


def run_port(pools_np, table, block_axis, primary, zb=None):
    pools = [to_torch(p) for p in pools_np]
    zbs = [to_torch(z) for z in (zb or zero_blocks_np(pools_np,
                                                      block_axis))]
    ops.fused_dispatch(pools, zbs, table, block_axis=block_axis,
                       primary=primary)
    return pools


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("block_axis", [0, 1])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seed", range(3))
def test_plain_drain_bitwise_matches_reference(layout, block_axis, dtype,
                                               seed):
    """Any table without duplicate writes: gather-then-scatter, bitwise
    equal to the jnp oracle (no tolerance: raw bytes are compared, see
    :func:`assert_same_bits` for the one bf16 NaN rule)."""
    sizes, primary = LAYOUTS[layout]
    rng = random.Random(seed)
    dt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    pools = make_pools(np.random.default_rng(seed), sizes, block_axis, dt)
    table = gen_table(rng, sizes, primary, 16, contract=False)
    want = jref.fused_dispatch([jnp.asarray(p) for p in pools],
                               [jnp.asarray(z) for z in
                                zero_blocks_np(pools, block_axis)],
                               jnp.asarray(table), block_axis=block_axis,
                               primary=primary)
    assert_same_bits(want, run_port(pools, table, block_axis, primary))


@pytest.mark.parametrize("layout,block_axis", [("ring", 1), ("ragged", 0)])
def test_plain_drain_matches_pallas_interpret(layout, block_axis):
    """On contract tables the plain drain equals the TPU kernel body run
    in interpret mode (serial drain), bitwise."""
    sizes, primary = LAYOUTS[layout]
    pools = make_pools(np.random.default_rng(7), sizes, block_axis,
                       np.float32)
    table = gen_table(random.Random(7), sizes, primary, 12, contract=True)
    want = fused_dispatch_pallas(
        [jnp.asarray(p) for p in pools],
        [jnp.asarray(z) for z in zero_blocks_np(pools, block_axis)],
        jnp.asarray(table), block_axis=block_axis, interpret=True,
        primary=primary, overlap=False)
    got = run_port(pools, table, block_axis, primary)
    for i, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(bits(w), bits(g), err_msg=f"pool {i}")


def _apply_rows(pools_np, rows, primary):
    """Apply rows one at a time, in the given order, through the plain
    drain (each row sees the state the rows before it left)."""
    pools = [to_torch(p) for p in pools_np]
    zbs = [to_torch(z) for z in zero_blocks_np(pools_np, 1)]
    for row in rows:
        ref.fused_dispatch(pools, zbs, np.asarray([row]), block_axis=1,
                           primary=primary)
    return pools


def _war_case(rng, sizes, primary, pools):
    """A contract table with non-adjacent WAR pairs whose order matters:
    applying its rows in reverse table order gives other bytes than the
    gather-then-scatter reference."""
    for _ in range(200):
        t = gen_table(rng, sizes, primary, 14, contract=True)
        live = [tuple(r) for r in t.tolist() if r[0] >= 0]
        waves = wave_schedule(live, sizes, primary)
        if max(waves) == 0:
            continue
        want = run_port(pools, t, 1, primary)
        back = _apply_rows(pools, reversed(live), primary)
        if any(not np.array_equal(bits(w), bits(b))
               for w, b in zip(want, back)):
            return t, live, waves, want
    raise AssertionError("no order-sensitive WAR table drawn")


@pytest.mark.parametrize("seed", range(6))
def test_wave_schedule_orders_war_pairs(seed):
    """Rows applied one at a time, wave by wave, shuffled inside each wave,
    equal the gather-then-scatter reference — the ordering the CUDA drain
    relies on — on tables where a wrong order (reverse) changes the
    bytes."""
    layout = sorted(LAYOUTS)[seed % 3]
    sizes, primary = LAYOUTS[layout]
    rng = random.Random(100 + seed)
    pools = make_pools(np.random.default_rng(seed), sizes, 1, np.float32)
    _, live, waves, want = _war_case(rng, sizes, primary, pools)
    order = []
    for w in range(max(waves) + 1):
        rows = [r for r, wv in zip(live, waves) if wv == w]
        rng.shuffle(rows)
        order += rows
    got = _apply_rows(pools, order, primary)
    for i, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(bits(w), bits(g), err_msg=f"pool {i}")


def test_wave_schedule_values_and_contract_errors():
    """Waves follow every earlier reader, adjacent or not; RAW and WAW
    pairs are refused (the kernel would drain them differently from the
    gather-then-scatter reference)."""
    sizes, primary = [16, 16, 4, 4], (True, True, False, False)
    rows = [(0, 1, 2), (0, 3, 4), (0, 5, 1), (3, -1, 5), (4, 32 + 1, 6)]
    # row 2 writes 1 (read by row 0) -> wave 1; row 3 writes 5 (read by
    # row 2 in wave 1) -> wave 2; the staging read of row 4 is independent
    assert wave_schedule(rows, sizes, primary) == [0, 0, 1, 2, 0]
    with pytest.raises(ValueError, match="RAW"):
        wave_schedule([(0, 1, 2), (0, 2, 3)], sizes, primary)
    with pytest.raises(ValueError, match="WAW"):
        wave_schedule([(0, 1, 2), (4, 7, 2)], sizes, primary)


# ---------------------------------------------------------------------------
# the Python statement of K1's plan
# ---------------------------------------------------------------------------

def _expand(op, s, d, sizes, primary):
    """The moves of one live row, restated: a plain row moves its block in
    each primary pool, the others name their pools by global id."""
    _, total, locate = ref.address_space(sizes)
    if op <= 3:
        return [(fd.ZERO, p, d, -1, -1, -1, -1) if op == 3 else
                (fd.COPY, p, d, p, s, -1, -1)
                for p in range(len(sizes)) if primary[p]]
    pd, ld = locate(d)
    if op == 4:
        return [(fd.COPY, pd, ld) + locate(s) + (-1, -1)]
    a, b = divmod(s, total)
    if op == 7:
        return [(fd.NOT, pd, ld) + locate(a) + (-1, -1)]
    return [((fd.AND, fd.OR)[op - 5], pd, ld) + locate(a) + locate(b)]


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("seed", range(3))
def test_plan_moves_follow_the_wave_schedule(layout, seed):
    """Every live row's moves, sorted by the row's wave (stable), each with
    the index of its wave's first move: the order and gates K1 gets."""
    sizes, primary = LAYOUTS[layout]
    table = gen_table(random.Random(200 + seed), sizes, primary, 24,
                      contract=True)
    moves, waves = fd.plan_moves(table, sizes, primary)
    live = [tuple(r) for r in table.tolist() if r[0] >= 0]
    assert waves == wave_schedule(live, sizes, primary)
    tagged = sorted(((w, mv) for r, w in zip(live, waves)
                     for mv in _expand(*r, sizes, primary)),
                    key=lambda x: x[0])
    first = {}
    for i, (w, _) in enumerate(tagged):
        first.setdefault(w, i)
    assert moves[:, :7].tolist() == [list(mv) for _, mv in tagged]
    assert moves[:, 7].tolist() == [first[w] for w, _ in tagged]


def run_moves(pools, moves, block_axis):
    """Execute a plan on CPU pools as K1's gate orders it: wave by wave
    (the moves sharing a ``first``), every read of the wave gathered from
    the state the earlier waves left, then every write scattered."""
    def page(p, b):
        return pools[p].select(block_axis, b)

    for w in np.unique(moves[:, 7]):
        writes = []
        for kind, pd, d, pa, a, pb, b, _ in moves[moves[:, 7] == w].tolist():
            dst = page(pd, d)
            if kind == fd.ZERO:
                val = torch.zeros_like(dst)
            elif kind == fd.COPY:
                val = page(pa, a).clone()
            else:
                x = ref.int_view(page(pa, a))
                val = (x & ref.int_view(page(pb, b)) if kind == fd.AND else
                       x | ref.int_view(page(pb, b)) if kind == fd.OR
                       else ~x).view(dst.dtype)
            writes.append((dst, val))
        for dst, val in writes:
            dst.copy_(val)
    return pools


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("block_axis", [0, 1])
@pytest.mark.parametrize("seed", range(2))
def test_plan_moves_drain_equals_reference(layout, block_axis, seed):
    """The plan run wave by wave equals the gather-then-scatter reference,
    bitwise, on tables with non-adjacent WAR pairs and chains."""
    sizes, primary = LAYOUTS[layout]
    rng = random.Random(300 + seed)
    pools = make_pools(np.random.default_rng(seed), sizes, block_axis,
                       ml_dtypes.bfloat16)
    for _ in range(200):
        table = gen_table(rng, sizes, primary, 20, contract=True)
        moves, waves = fd.plan_moves(table, sizes, primary)
        if max(waves, default=0) > 0:
            break
    want = jref.fused_dispatch([jnp.asarray(p) for p in pools],
                               [jnp.asarray(z) for z in
                                zero_blocks_np(pools, block_axis)],
                               jnp.asarray(table), block_axis=block_axis,
                               primary=primary)
    got = run_moves([to_torch(p) for p in pools], moves, block_axis)
    assert_same_bits(want, got)


@pytest.mark.parametrize("layout,block_axis", [("ring", 1), ("ragged", 0)])
def test_plan_moves_drain_matches_pallas_interpret(layout, block_axis):
    """The plan run wave by wave equals the TPU kernel body in interpret
    mode, bitwise."""
    sizes, primary = LAYOUTS[layout]
    pools = make_pools(np.random.default_rng(9), sizes, block_axis,
                       np.float32)
    table = gen_table(random.Random(9), sizes, primary, 16, contract=True)
    want = fused_dispatch_pallas(
        [jnp.asarray(p) for p in pools],
        [jnp.asarray(z) for z in zero_blocks_np(pools, block_axis)],
        jnp.asarray(table), block_axis=block_axis, interpret=True,
        primary=primary, overlap=False)
    moves, _ = fd.plan_moves(table, sizes, primary)
    got = run_moves([to_torch(p) for p in pools], moves, block_axis)
    for i, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_array_equal(bits(w), bits(g), err_msg=f"pool {i}")


#: RING's global ids: K, V, K stage, V stage pools of 16, 16, 4, 4 blocks
_K, _V, _KS, _VS = 0, 16, 32, 36
REFUSED = {
    "raw plain": ([(0, 1, 2), (0, 2, 3)], "RAW", 1),
    "waw plain over cross": ([(0, 1, 2), (4, _KS + 1, _V + 2)], "WAW", 1),
    "raw cross reads a plain write": ([(3, -1, 5), (4, _K + 5, _KS)], "RAW",
                                      1),
    "raw bitwise reads a staging write": (
        [(4, _K + 1, _KS + 2), (5, (_KS + 2) * 40 + _K, _V + 9)], "RAW", 1),
    "waw staging": ([(4, _K + 1, _VS), (7, (_V + 3) * 41, _VS)], "WAW", 1),
}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_plan_moves_refuses_raw_and_waw(case):
    """A table breaking the contract is refused with the schedule's message
    naming the row (the CUDA wrapper raises the same text)."""
    rows, kind, bad = REFUSED[case]
    sizes, primary = LAYOUTS["ring"]
    with pytest.raises(ValueError) as err:
        fd.plan_moves(np.asarray(rows), sizes, primary)
    assert str(err.value).startswith(f"row {rows[bad]} ")
    assert str(err.value).endswith(f"({kind})")
    assert str(err.value) == str(fd.refusal(fd.RAW if kind == "RAW" else
                                            fd.WAW, np.asarray(rows), bad,
                                            sizes))


@pytest.mark.parametrize("case", ["serving", "few", "unaligned"])
def test_k1_chunking(case):
    """K1's work items: 128 KiB layer-stacked pages in 32 KiB chunks on one
    CTA per SM (a ring of 4 slots and the zero tile), a small call in 4 KiB
    chunks with more CTAs per SM, and unaligned pages whole on the word
    path."""
    if case == "serving":
        got = fd.chunking(24, 28, 131072, bulk=True, sms=132)
        assert got == (32768, 4, 24 * 28 * 4, 132)
    elif case == "few":
        got = fd.chunking(8, 1, 131072, bulk=True, sms=132)
        # 1 MiB over 264 slots: 4 KiB chunks; 5 x 4 KiB + 1 KiB a CTA
        assert got == (4096, 32, 256, 256)
        assert 232448 // (5 * 4096 + 1024) >= 8
    else:
        got = fd.chunking(300, 1, 204, bulk=False, sms=132)
        assert got == (204, 1, 300, 300)
    chunk, cpp, items, grid = got
    assert chunk * cpp >= (131072 if case != "unaligned" else 204)


@pytest.mark.parametrize("dtype,block", [("float32", (3,)),
                                         ("bfloat16", (5,))])
@pytest.mark.parametrize("block_axis", [0, 1])
def test_plain_drain_unaligned_block_shape_matches_reference(dtype, block,
                                                             block_axis):
    """Blocks of 12 and 10 bytes (no 16-byte word fits; the CUDA drain
    takes its word loop there) drain bitwise as the jnp oracle does."""
    sizes, primary = LAYOUTS["ring"]
    dt = np.float32 if dtype == "float32" else ml_dtypes.bfloat16
    rng = np.random.default_rng(11)
    pools = [rng.standard_normal(((n,) if block_axis == 0 else (2, n))
                                 + block).astype(np.float32).astype(dt)
             for n in sizes]
    table = gen_table(random.Random(11), sizes, primary, 20, contract=True)
    zb = zero_blocks_np(pools, block_axis)
    want = jref.fused_dispatch([jnp.asarray(p) for p in pools],
                               [jnp.asarray(z) for z in zb],
                               jnp.asarray(table), block_axis=block_axis,
                               primary=primary)
    assert_same_bits(want, run_port(pools, table, block_axis, primary, zb))
