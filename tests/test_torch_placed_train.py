"""The blocks of the port's placed training step, on the CPU (the step
itself against the reference's jitted sharded step is in
``tests/test_torch_mesh_train.py`` and ``tests/test_torch_mesh_elastic.py``):

* ``common.chunked_softmax_xent_placed`` against ``chunked_softmax_xent``
  whole, value and grads, the vocabulary split over ``model`` with a label
  in every block, masked positions and a whole masked row, a tied and an
  untied head, chunks that divide the sequence and a shorter last chunk,
  under both rule sets (the log-partitions of the vocabulary blocks
  combined, the sums added in another order: rtol 1e-6 on the value; the
  grads within 2^-6 of the leaf's largest: the logits are bf16 products,
  and their bf16 cotangents meet x's and the head's grads summed over the
  vocabulary or batch blocks where the whole call sums them inside one
  product, a bf16 ulp (2^-8) or two apart, 0.0065 the worst seen);
* ``attention.attention_train_placed`` against ``attention_train`` whole
  (and ``flash_attention`` for a cross-attention, Skv != S), per strategy,
  with a ``prefix_len`` and non-causal: each block is the same online
  softmax on fewer rows or heads, atol 1e-6 on outputs, 1e-5 on grads;
* ``op_cost.Walk.join`` under autograd: each piece of a joined slice gets
  a grad of its shape on its rank, and the bytes of its slice count to the
  join's path on the piece's rank (bf16 bytes for a bf16 view of fp32
  pieces);
* a bf16 view's readers' weight grads meet in fp32 on the master blocks;
* a step over a mesh gathers nothing whole (``launch.mesh.gather`` is
  never called) and leaves every rank's master blocks where they lay;
* a placed moe FFN's aux loss on the local path (each batch group routes
  its rows) is the whole batch's, as ``moe_ffn_local``'s (the groups'
  sums combined): rtol 1e-6, outputs within 1e-6.
"""
import numpy as np
import pytest
import torch

from test_torch_contract import one_thread  # noqa: F401

from repro_torch.configs import TrainConfig, get_config
from repro_torch.data import batch_logical_axes, make_batch, to_device
from repro_torch.launch import mesh as tmesh
from repro_torch.launch import train as ttrain
from repro_torch.launch.op_cost import Walk
from repro_torch.models import attention as tatt
from repro_torch.models import common, moe
from repro_torch.sharding import rules
from repro_torch.weights import init_params, params_axes

pytestmark = pytest.mark.usefixtures("one_thread")

RULES = {"default": rules.DEFAULT_RULES, "fsdp": rules.FSDP_RULES}


def placed_view(x: torch.Tensor, sh: tmesh.Sharding) -> tmesh.Sharded:
    """``x`` laid out by ``sh`` through autograd (blocks are slices of x,
    so grads reach x)."""
    return tmesh.map_blocks(sh, x.shape, lambda b, sl, r: x[sl])


# ---------------------------------------------------------------------------
# the loss by blocks
# ---------------------------------------------------------------------------

#: (rule set, tied, S, chunk)
XENT_CASES = [("default", False, 22, 8), ("default", True, 22, 8),
              ("default", False, 21, 8), ("fsdp", True, 22, 8),
              ("fsdp", False, 21, 4)]


@pytest.mark.parametrize("rule_set,tied,S,chunk", XENT_CASES)
def test_placed_xent_matches_the_whole_call(rule_set, tied, S, chunk):
    rng = np.random.default_rng(S + chunk + tied)
    B, d, V = 4, 16, 64
    mesh = tmesh.make_test_mesh((2, 2), ("data", "model"), devices="cpu")
    x = torch.tensor(rng.standard_normal((B, S, d)), dtype=torch.float32,
                     requires_grad=True)
    w = torch.tensor(0.3 * rng.standard_normal((V, d) if tied else (d, V)),
                     dtype=torch.float32, requires_grad=True)
    labels = torch.tensor(rng.integers(0, V, (B, S)), dtype=torch.int32)
    labels[0, :2] = torch.tensor([3, V - 3])      # a label in every block
    mask = torch.ones((B, S))
    mask[:, 5] = 0
    mask[1] = 0                                     # a whole masked row
    want = common.chunked_softmax_xent(x, w.T if tied else w, labels, mask,
                                       chunk=chunk)
    gw = torch.autograd.grad(want, (x, w))
    with rules.use_rules(RULES[rule_set]):
        xs = tmesh.sharding_for(mesh, x.shape, ("batch", "act_seq_tp",
                                                None))
        ws = tmesh.sharding_for(mesh, w.shape, ("vocab", "embed") if tied
                                else ("embed", "vocab"))
        bs = tmesh.sharding_for(mesh, labels.shape, ("batch", None))
        got = common.chunked_softmax_xent_placed(
            placed_view(x, xs), placed_view(w, ws), tied,
            tmesh.place(labels, bs), tmesh.place(mask, bs), chunk=chunk)
        vocab = common.spec_entry(placed_view(w, ws), 0 if tied else 1)
    gg = torch.autograd.grad(got, (x, w))
    assert vocab == ("model" if rule_set == "default" else None)
    np.testing.assert_allclose(float(got.detach()), float(want.detach()),
                               rtol=1e-6)
    for a, b in zip(gg, gw):
        assert float((a - b).abs().max()) <= 2 ** -6 * float(b.abs().max())


def test_placed_xent_skips_the_prefix_rows():
    """``offset``: the loss reads x's rows from it on (the vlm's text after
    its patch prefix), as the whole call on ``x[:, offset:]``."""
    rng = np.random.default_rng(7)
    B, P, S, d, V = 2, 6, 16, 8, 32
    mesh = tmesh.make_test_mesh((2, 2), ("data", "model"), devices="cpu")
    x = torch.tensor(rng.standard_normal((B, P + S, d)), dtype=torch.float32)
    w = torch.tensor(rng.standard_normal((d, V)), dtype=torch.float32)
    labels = torch.tensor(rng.integers(0, V, (B, S)))
    mask = torch.ones((B, S))
    want = common.chunked_softmax_xent(x[:, P:], w, labels, mask, chunk=8)
    xs = tmesh.sharding_for(mesh, x.shape, ("batch", "act_seq_tp", None))
    got = common.chunked_softmax_xent_placed(
        tmesh.place(x, xs), tmesh.place(w, tmesh.Sharding(mesh, (None,
                                                                 "model"))),
        False, labels, mask, offset=P, chunk=8)
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


# ---------------------------------------------------------------------------
# the training attention by blocks
# ---------------------------------------------------------------------------

#: name -> (mesh shape, axes, rules, strategy, B, S, Skv, H, KVH, prefix,
#: causal, the q blocks it runs)
ATTN_CASES = {
    "heads, K/V sharded": ((2, 4), ("data", "model"), "default", "heads",
                           2, 16, 16, 8, 4, 0, True, 8),
    "heads, straddling a group": ((2, 4), ("data", "model"), "default",
                                  "heads", 2, 16, 16, 12, 3, 0, True, 8),
    "heads, prefix-LM": ((1, 4), ("data", "model"), "default", "heads",
                         2, 16, 16, 8, 2, 5, True, 4),
    "seq": ((2, 4), ("data", "model"), "default", "seq", 2, 16, 16, 6, 2,
            0, True, 8),
    "seq, prefix-LM": ((1, 4), ("data", "model"), "default", "seq", 2, 16,
                       16, 6, 3, 5, True, 4),
    "heads, non-causal": ((2, 2), ("data", "model"), "default", "heads",
                          2, 16, 16, 4, 2, 0, False, 4),
    "seq, non-causal": ((2, 2), ("data", "model"), "default", "seq", 2, 16,
                        16, 3, 1, 0, False, 4),
    "cross, Skv != S": ((2, 2), ("data", "model"), "default", "heads", 2,
                        16, 6, 4, 4, 0, False, 4),
    "fsdp, batch over every axis": ((2, 2), ("data", "model"), "fsdp",
                                    "heads", 4, 16, 16, 4, 2, 0, True, 4),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_placed_training_attention_matches_the_whole_call(case,
                                                          monkeypatch):
    shape, axes, rule_set, strategy, B, S, Skv, H, KVH, prefix, causal, \
        n_blocks = ATTN_CASES[case]
    rng = np.random.default_rng(len(case))
    D = 8
    q = torch.tensor(rng.standard_normal((B, S, H, D)), dtype=torch.float32,
                     requires_grad=True)
    k, v = (torch.tensor(rng.standard_normal((B, Skv, KVH, D)),
                         dtype=torch.float32, requires_grad=True)
            for _ in range(2))
    dout = torch.tensor(rng.standard_normal((B, S, H, D)),
                        dtype=torch.float32)
    pos = torch.arange(S).expand(B, S)
    info = tatt.MaskInfo(causal, prefix)
    if Skv == S:
        whole = tatt.attention_train(q, k, v, pos, info, kv_chunk=8)
    else:
        zq, zk = torch.zeros((B, S), dtype=torch.long), \
            torch.zeros((B, Skv), dtype=torch.long)
        whole = tatt.flash_attention(q, k, v, zq, zk,
                                     torch.ones((B, Skv), dtype=torch.bool),
                                     info, kv_chunk=8)
    gw = torch.autograd.grad((whole * dout).sum(), (q, k, v))
    blocks = []
    flash = tatt.flash_attention
    monkeypatch.setattr(tatt, "flash_attention", lambda *a, **kw: (
        blocks.append(tuple(a[0].shape[:3])) or flash(*a, **kw)))
    mesh = tmesh.make_test_mesh(shape, axes, devices="cpu")
    with rules.use_rules(RULES[rule_set]):
        qsh, ksh = tatt.placed_qkv_shardings(mesh, strategy, B, S, H, KVH)
        if Skv != S:
            ksh = tmesh.sharding_for(mesh, (B, Skv, KVH * D),
                                     ("batch", None, None))
        pq = placed_view(q.reshape(B, S, H * D), qsh)
        pk, pv = (placed_view(t.reshape(B, Skv, KVH * D), ksh)
                  for t in (k, v))
        ppos = tmesh.place(pos, tmesh.Sharding(mesh, qsh.spec[:2]))
        got = tatt.attention_train_placed(pq, pk, pv, ppos if causal
                                          else None, H, KVH, D, info,
                                          kv_chunk=8)
    out = tmesh.gather(got).reshape(B, S, H, D)
    gm = torch.autograd.grad((out * dout).sum(), (q, k, v))
    assert len(blocks) == n_blocks, blocks
    assert got.sharding == qsh
    np.testing.assert_allclose(out.detach().numpy(), whole.detach().numpy(),
                               atol=1e-6)
    for a, b in zip(gm, gw):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


# ---------------------------------------------------------------------------
# the walk's join under autograd
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("cast", [None, torch.bfloat16])
def test_walk_join_hands_each_piece_its_grad(cast):
    """A slice of a (2, 2)-placed value across four blocks, joined on rank
    3 under a walk: forward counts the three remote slices to the path on
    rank 3; backward gives each block a grad of its shape on its own rank
    and counts each remote slice's bytes to the same path on that rank.
    Read as bf16 (``Sharded.cast``, a training step's view of its fp32
    masters) the slices move, and their grads move back, as bf16 bytes;
    the grads are the masters' fp32."""
    mesh = tmesh.make_test_mesh((2, 2), ("data", "model"), devices="meta")
    sh = tmesh.Sharding(mesh, ("data", "model"))
    with Walk(mesh.size) as walk:
        x = tmesh.place(torch.empty((8, 6), device="meta"), sh)
        for t in tmesh.pieces(x):
            t.requires_grad_(True)
        view = tmesh.Sharded(sh, x.shape, x.blocks, cast)
        index = (slice(2, 7), slice(1, 5))
        out = {}

        def fn():
            y = tmesh.take(view, 3, index, path="gather")
            out["fwd"] = [dict(p) for p in walk.rank_paths]
            out["shape"], out["dtype"] = tuple(y.shape), y.dtype
            out["rank"] = walk.rank_of(y)
            out["grads"] = torch.autograd.grad(y.float().sum(),
                                               tmesh.pieces(x))

        walk.run(fn, [x])
    owners = sh.owners()
    size = 2 if cast else 4
    # the part of the slice each block holds, in elements
    part = {(0, 0): 2 * 2, (0, 1): 2 * 2, (1, 0): 3 * 2, (1, 1): 3 * 2}
    assert out["shape"] == (5, 4) and out["rank"] == 3
    assert out["dtype"] == (cast or torch.float32)
    remote = sum(size * n for b, n in part.items() if owners[b] != 3)
    assert out["fwd"][3]["gather"] == remote
    for (b, t), g in zip(x.blocks.items(), out["grads"]):
        assert g.shape == t.shape and walk.rank_of(g) == owners[b]
        assert g.dtype == torch.float32
        r = owners[b]
        if r != 3:
            assert walk.rank_paths[r]["gather"] == size * part[b], b
    assert sum(walk.rank_paths[r]["gather"] for r in range(4)) == 2 * remote


def test_view_readers_grads_meet_in_fp32():
    """Two ranks each read a (2,)-placed fp32 master whole through its
    bf16 view (``bf16_views``) for a product of their own: each read moves
    bf16, and the master's blocks take the sum of the two readers' bf16
    weight grads in fp32 (as one device's microbatches sum theirs), not
    their bf16 sum."""
    mesh = tmesh.make_test_mesh((2,), ("model",), devices="cpu")
    rng = np.random.default_rng(0)
    w = torch.tensor(rng.standard_normal((16, 8)), dtype=torch.float32)
    xs, dys = ([torch.tensor(rng.standard_normal(shape),
                             dtype=torch.bfloat16) for _ in range(2)]
               for shape in ((32, 16), (32, 8)))
    master = tmesh.place(w, tmesh.Sharding(mesh, ("model", None)))
    for t in tmesh.pieces(master):
        t.requires_grad_(True)
    view = ttrain.bf16_views({"w": master})["w"]
    assert view.dtype == torch.bfloat16 and view.blocks is master.blocks
    reads = [tmesh.take(view, r) for r in range(2)]
    assert all(t.dtype == torch.bfloat16 for t in reads)
    total = sum(((x @ t) * dy).float().sum()
                for x, t, dy in zip(xs, reads, dys))
    got = torch.autograd.grad(total, tmesh.pieces(master))
    # each reader's bf16 weight grad, as one device computes it
    per = [x.T @ dy for x, dy in zip(xs, dys)]
    want = per[0].float() + per[1].float()
    assert not torch.equal((per[0] + per[1]).float(), want)
    for g, rows in zip(got, (slice(0, 8), slice(8, 16))):
        assert torch.equal(g, want[rows])


# ---------------------------------------------------------------------------
# the step over a mesh gathers nothing whole
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sharding", ["fsdp", "tp"])
def test_mesh_step_gathers_nothing_whole(sharding, monkeypatch):
    """``make_train_step(mesh=)`` over (2, 2) CPU ranks, ``gather``
    refused: the step runs (no weight, view or batch leaf is gathered
    whole), the loss is one device's (rtol 1e-5) and every master block
    keeps its owner's device and its shape."""
    cfg = get_config("llama3.2-3b").reduced()
    kw = dict(total_steps=8, warmup_steps=1, sharding=sharding)
    batch = to_device(make_batch(cfg, 4, 32, 0), "cpu")
    one = init_params(cfg, 0, "cpu", param_dtype=torch.float32)
    _, m1 = ttrain.make_train_step(one, TrainConfig(**kw))(
        ttrain.train_state(one), batch)
    model = init_params(cfg, 0, "cpu", param_dtype=torch.float32)
    mesh = tmesh.make_test_mesh((2, 2), ("data", "model"), devices="cpu")
    step, shard_state, _ = ttrain.build_train_step(
        model, TrainConfig(**kw), mesh, params_axes(model),
        batch_logical_axes(cfg))
    state = ttrain.train_state(model, shard_state(dict(
        model.named_parameters())))
    shapes = {n: [tuple(t.shape) for t in tmesh.pieces(p)]
              for n, p in state.params.items()}

    def refuse(*a, **kw):
        raise AssertionError("gathered whole")

    for mod in (tmesh, ttrain, common):
        monkeypatch.setattr(mod, "gather", refuse)
    state, m = step(state, batch)
    assert float(m["loss"]) == pytest.approx(float(m1["loss"]), rel=1e-5)
    assert {n: [tuple(t.shape) for t in tmesh.pieces(p)]
            for n, p in state.params.items()} == shapes
    assert all(p.numel() == 0 for p in model.parameters())


# ---------------------------------------------------------------------------
# the moe aux loss on the placed local path
# ---------------------------------------------------------------------------

def test_placed_moe_local_path_aux_is_the_whole_batch():
    """deepseek-moe-16b reduced with 64 experts top 6 over (2, 4) ranks
    under ``DEFAULT_RULES`` at S = 30 (4 does not divide it: the
    all-to-all falls back to the local path): each of the 2 batch groups
    routes its rows on its first rank, and the aux loss combined from the
    groups' sums equals ``moe_ffn_local``'s over the whole batch."""
    import dataclasses
    cfg = dataclasses.replace(get_config("deepseek-moe-16b").reduced(),
                              num_experts=64, top_k=6)
    model = init_params(cfg, 0, "cpu", param_dtype=torch.float32)
    p = model.layers[0].moe
    h = torch.randn((4, 30, cfg.d_model), generator=torch.Generator()
                    .manual_seed(3))
    want_y, want_aux = moe.moe_ffn_local(p, h, cfg)
    mesh = tmesh.make_test_mesh((2, 4), ("data", "model"), devices="cpu")
    sh = tmesh.sharding_for(mesh, h.shape, ("batch", "act_seq_tp", None))
    assert moe.moe_path(mesh, h.shape, cfg) == "local"
    moe.PATH_COUNTS.clear()
    y, aux = moe.moe_ffn_placed(p, tmesh.place(h, sh), cfg, sh,
                                with_aux=True)
    assert dict(moe.PATH_COUNTS) == {"local": 1}
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-6)
    np.testing.assert_allclose(tmesh.gather(y).numpy(), want_y.numpy(),
                               atol=1e-6)
