"""The op-cost walk (``repro_torch/launch/op_cost.py``, the counterpart of
``repro/launch/hlo_analysis.py``) and the kernels' cost rules
(``repro_torch/kernels/cost.py``), on the CPU over ``meta`` tensors.

* The reduced llama3.2-3b train cell (B = 2, S = 128, one rank), built as
  the reference's dry-run builds it, against the reference's compiled
  cell: argument bytes equal ``memory_analysis()``'s, and the walk's
  FLOPs equal ``analyse_hlo``'s loop-aware count plus two named terms of
  recomputation the port runs and the reference's HLO does not (a stated
  tolerance of 6.2%, met exactly by the terms).
* Each of K1-K7 at its boundary: the walk counts ``kernels/cost.py``'s
  work for the call and nothing of the plain version that gives the
  outputs their shapes; K3 and K4 at ``PERF.md`` §6's shapes.
* A (2, 2) ``"fsdp"`` cell: each rank's argument bytes equal
  ``rank_bytes`` of the placed state and batch; a ``gather``'s peer bytes
  equal the bytes of the blocks on other ranks.
* Refusals: a walk over a tensor that is not ``meta`` raises.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import ShapeConfig, get_config
from repro_torch.kernels import cost, ops
from repro_torch.launch.mesh import (Sharding, gather, make_test_mesh,
                                     on_rank, place, rank_bytes, rank_scope,
                                     to_rank, to_rank_of)
from repro_torch.launch.op_cost import Walk, WalkError

META = torch.device("meta")

#: the reference's reduced cell: llama3.2-3b reduced, train, B x S
REF_ARCH, REF_B, REF_S = "llama3.2-3b", 2, 128


def _reference_cell():
    """(argument bytes, loop-aware FLOPs) of the reference's reduced train
    cell, built as ``repro/launch/dryrun.py build_cell`` builds it (that
    module is not imported: its import rewrites ``XLA_FLAGS``), on one CPU
    device."""
    import jax

    from repro.configs import TrainConfig as JTrainConfig
    from repro.configs import get_config as jget_config
    from repro.data import batch_logical_axes as jaxes
    from repro.data import batch_specs as jspecs
    from repro.launch.hlo_analysis import analyse_hlo
    from repro.launch.train import TrainState, build_jit_train_step
    from repro.models import build_model, split_params
    from repro.optim import init_state
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    cfg = jget_config(REF_ARCH).reduced()
    model = build_model(cfg)
    params, axes = split_params(jax.eval_shape(
        lambda k: model.init_params(k), jax.random.key(0)))
    step_fn, shard_state, batch_sh = build_jit_train_step(
        model, JTrainConfig(), mesh, axes, jaxes(cfg))
    b = jspecs(cfg, REF_B, REF_S)
    with mesh:
        compiled = jax.jit(step_fn, in_shardings=(
            shard_state(params), batch_sh(b)), donate_argnums=(0,)).lower(
            TrainState(params, jax.eval_shape(init_state, params)),
            b).compile()
    return (compiled.memory_analysis().argument_size_in_bytes,
            analyse_hlo(compiled.as_text())["flops"])


def _train_cell(cfg, mesh, B, S):
    """The dry-run's train cell built inside the active walk."""
    from repro_torch.launch.dryrun import build_cell
    return build_cell(cfg, ShapeConfig("t", S, B, "train"), mesh)


def test_reduced_train_cell_against_the_reference():
    """Argument bytes 8,667,652 (fp32 masters, m and v of 722,048
    parameters, the step, the batch) as the reference's
    ``memory_analysis``; the walk's FLOPs equal FlopCounterMode's
    formulas over the step, and exceed the reference's loop-aware
    1,644,167,168 by exactly two named terms: the training attention's
    forward a third time (the port checkpoints each KV chunk inside the
    layer's remat, so backward's recomputation of the layer runs each
    chunk's forward and that chunk's backward runs it again: 4 B H S^2 D
    a layer) and the loss head's logits product once more (the port's
    checkpointed loss chunk recomputes it in backward; the reference's
    optimized HLO computes it once: 2 B S d V).  Tolerance: 6.2%,
    relative, met exactly by those terms."""
    ref_args, ref_flops = _reference_cell()
    cfg = get_config(REF_ARCH).reduced()
    mesh = make_test_mesh((1, 1), devices="meta")
    with Walk(1) as walk:
        fn, arguments = _train_cell(cfg, mesh, REF_B, REF_S)
        walk.run(fn, arguments)
    assert walk.arguments[0] == ref_args == 8_667_652
    B, S, H, D, L = REF_B, REF_S, cfg.num_heads, cfg.head_dim, \
        cfg.num_layers
    attention_third = 4 * B * H * S * S * D * L
    head_again = 2 * B * S * cfg.d_model * cfg.padded_vocab
    assert (attention_third, head_again) == (67_108_864, 33_554_432)
    assert ref_flops == 1_644_167_168
    assert walk.flops[0] == ref_flops + attention_third + head_again
    assert abs(walk.flops[0] / ref_flops - 1) <= 0.062
    from repro_torch.launch.dryrun import analyse
    row = analyse(walk, cfg, ShapeConfig("t", S, B, "train"), 1)
    assert row["model_flops_per_dev"] == 1_108_869_120
    # the masters and moments are updated in place (they alias the
    # arguments); the step advances into a new tensor
    assert row["memory"]["alias_size_in_bytes"] == 3 * 2_888_192


def test_walk_reports_the_reference_keys():
    """Per rank, the walk gives ``hlo_analysis``'s keys (flops, bytes,
    wire_bytes) and the peak live bytes."""
    from repro.launch.hlo_analysis import analyse_hlo
    keys = {"flops", "bytes", "wire_bytes"}
    assert keys <= set(analyse_hlo(""))
    walk = Walk(2)
    with walk:
        a = torch.empty((64, 32), device=META)
        walk.run(lambda: a @ a.T, (a,))
    got = walk.rank_cost(0)
    assert keys | {"peak_bytes"} <= set(got)
    assert got["flops"] == 2 * 64 * 64 * 32
    # read a (8 KiB) twice as both operands, write 64 x 64 fp32
    assert got["bytes"] == 2 * 64 * 32 * 4 + 64 * 64 * 4
    assert got["peak_bytes"] == 64 * 32 * 4 + 64 * 64 * 4


def _meta(*shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device=META)


def _k_calls():
    """Each kernel's entry on meta tensors: (name, call, work)."""
    L, nblk, page, kvh, D = 2, 16, 64, 8, 128
    pools = [_meta(L, nblk, page, kvh, D), _meta(L, nblk, page, kvh, D)]
    zeros = [_meta(1, page, kvh, D), _meta(1, page, kvh, D)]
    table = np.array([[0, 1, 2], [3, -1, 5], [-1, 0, 0], [4, 17, 3]],
                     np.int32)
    ids2 = np.array([[0, 3], [1, -1], [2, 4]], np.int64)
    ids1 = np.array([5, -1, 6], np.int64)
    rows = np.array([[0, 0, 1, 2, 1], [0, 1, 3, 0, -1]], np.int64)
    slabs = [_meta(L, 8, page, kvh, D), _meta(L, 8, page, kvh, D)]
    q, kv = _meta(4, 24, 128), _meta(32, page, 8, 128)
    mask, base, lens = (_meta(32, 4, dtype=torch.int8),
                        _meta(32, dtype=torch.int32),
                        _meta(4, dtype=torch.int32))
    q3, k3 = _meta(1, 24, 512, 128), _meta(1, 8, 512, 128)
    x4, f4, b4 = (_meta(8, 256, 48, 64), _meta(8, 256, 48,
                                               dtype=torch.float32),
                  _meta(8, 256, 128))
    return [
        ("K1", lambda: ops.fused_dispatch(pools, zeros, table,
                                          block_axis=1),
         cost.k1_work(pools, table, block_axis=1)),
        ("K2", lambda: ops.paged_attention_slab(q, kv, kv, mask, base, lens,
                                                page=page),
         cost.k2_work(q, kv, kv, mask, base, lens, page=page, fill=512)),
        ("K3", lambda: ops.flash_attention(q3, k3, k3),
         cost.k3_work(q3, k3, k3)),
        ("K4", lambda: ops.ssd_intra_chunk(x4, f4, f4, b4, b4),
         cost.k4_work(x4, f4, f4, b4, b4)),
        ("K5a", lambda: ops.fpm_copy(pools[0], ids2, block_axis=1),
         cost.k5_work(pools[0], ids2, block_axis=1)),
        ("K5b", lambda: ops.fpm_copy_cross(pools[0], pools[1], ids2,
                                           block_axis=1),
         cost.k5_work(pools[0], ids2, block_axis=1)),
        ("K6", lambda: ops.meminit_zero(pools[0], ids1, block_axis=1),
         cost.k6_work(pools[0], ids1, block_axis=1)),
        ("K7", lambda: ops.psm_transfer_rows([(slabs, slabs)], rows,
                                             block_axis=1),
         cost.k7_work(slabs[0], rows, block_axis=1)),
    ]


@pytest.mark.parametrize("name", ["K1", "K2", "K3", "K4", "K5a", "K5b", "K6",
                                  "K7"])
def test_kernel_counts_its_cost_rule_at_the_boundary(name):
    """Under a walk each entry point counts ``kernels/cost.py``'s work for
    its call, once, and nothing of the plain version that gives its
    outputs their shapes (no op is counted)."""
    with Walk(1, fill=512) as walk:
        (_, call, work), = [c for c in _k_calls() if c[0] == name]
        walk.run(call)
    assert walk.kernels == {name: {"calls": 1, "bytes": work.bytes,
                                   "flops": work.flops}}
    assert walk.ops == 0
    assert (walk.bytes[0], walk.flops[0]) == (work.bytes, work.flops)
    assert work.bytes > 0


def test_k3_k4_bytes_at_the_perf_shapes():
    """``PERF.md`` §6's bound bytes: K3 at D=128, S=512, H=24, KVH=8;
    K4 at Bc=8, Q=256, H=48, N=128."""
    q, k = _meta(1, 24, 512, 128), _meta(1, 8, 512, 128)
    assert cost.k3_work(q, k, k).bytes == 8_388_608
    x, f, b = (_meta(8, 256, 48, 64), _meta(8, 256, 48, dtype=torch.float32),
               _meta(8, 256, 128))
    assert cost.k4_work(x, f, f, b, b).bytes == 39_583_744


def test_k2_shape_only_form_equals_the_exact_form_on_the_declared_layout():
    """On the identity layout at a declared fill (every block full), K2's
    shape-only work equals the work its values give; a fill the page does
    not divide is refused."""
    from repro_torch.models.paged import identity_layout
    B, page, fill = 4, 64, 256
    _, mask, base = identity_layout(B, fill, page)
    lens = np.full(B, fill, np.int32)
    q = torch.zeros((B, 24, 128), dtype=torch.bfloat16)
    kv = torch.zeros((len(base), page, 8, 128), dtype=torch.bfloat16)
    exact = cost.k2_work(q, kv, kv, torch.from_numpy(mask),
                         torch.from_numpy(base), torch.from_numpy(lens),
                         page=page)
    args = (q.to(META), kv.to(META), kv.to(META), _meta(len(base), B),
            _meta(len(base)), _meta(B))
    assert cost.k2_work(*args, page=page, fill=fill) == exact
    with pytest.raises(ValueError, match="declared fill"):
        cost.k2_work(*args, page=page, fill=fill - 1)


def test_fsdp_cell_arguments_equal_rank_bytes():
    """A (2, 2) ``"fsdp"`` train cell: each rank's argument bytes equal
    ``rank_bytes`` of the placed masters, both moments, the step and the
    placed batch."""
    cfg = get_config(REF_ARCH).reduced()
    mesh = make_test_mesh((2, 2), devices="meta")
    with Walk(4) as walk:
        fn, (state, batch) = _train_cell(cfg, mesh, 4, 64)
        walk.run(fn, (state, batch))
    values = [*state.params.values(), *state.opt.m.values(),
              *state.opt.v.values(), state.opt.step, *batch.values()]
    assert walk.arguments == rank_bytes(values, mesh)
    assert walk.arguments[1] > 0 and walk.peak[0] > walk.arguments[0]
    # the loss runs whole on rank 0: its views come over from the others
    assert walk.rank_paths[0]["gather"] > 0
    assert walk.busiest() == 0


def test_gather_peer_bytes_equal_the_remote_blocks():
    """``gather`` onto rank 0 counts the bytes of every block another rank
    holds as peer bytes into rank 0, on the ``"gather"`` path."""
    mesh = make_test_mesh((2, 2), devices="meta")
    with Walk(4) as walk:
        x = place(_meta(64, 32, dtype=torch.float32),
                  Sharding(mesh, ("data", "model")))
        walk.run(lambda: gather(x, mesh.devices[0]), x)
    owners = x.sharding.owners()
    remote = sum(t.numel() * 4 for b, t in x.blocks.items()
                 if owners[b] != 0)
    assert len(x.blocks) > 1 and remote > 0
    assert walk.peer == [remote, 0, 0, 0]
    assert walk.rank_paths[0] == {"gather": remote}


def test_scope_and_moves_place_the_work():
    """Inside ``rank_scope(r)`` ops run on ``r``; an in-place op runs where
    its target lies; ``to_rank`` copies onto a rank and its backward moves
    the grad back; without a walk every hook is the plain call."""
    mesh = make_test_mesh((1, 2), devices="meta")
    with Walk(2) as walk:
        a = _meta(16, 16, dtype=torch.float32).requires_grad_(True)
        slab = on_rank(_meta(16, 16, dtype=torch.float32), 1)

        def fn():
            with rank_scope(1):
                b = to_rank(a, mesh, 1, path="attention") * 2
            c = to_rank_of(b, a, path="attention")
            slab.copy_(c.detach())
            (g,) = torch.autograd.grad(c.sum(), a)
            return g
        walk.run(fn, (a, slab))
    assert walk.rank_of(slab) == 1
    n = 16 * 16 * 4
    # forward: a -> 1, b -> 0, c -> slab (copy_ reads c on 0); backward:
    # the grad -> 1 and back to 0
    assert walk.rank_paths[1]["attention"] == 2 * n
    assert walk.rank_paths[0]["attention"] == 2 * n
    assert walk.rank_paths[1]["other"] == n
    x = torch.ones(3)
    assert to_rank(x, make_test_mesh((1, 1), devices="cpu"), 0) is x
    assert on_rank(x, 3) is x and to_rank_of(x, x) is x
    with rank_scope(2):
        assert torch.equal(x * 2, torch.full((3,), 2.0))


def test_peak_follows_storage_lifetimes():
    """Peak live bytes: a temporary counts while it lives; freed storage
    leaves the count."""
    with Walk(1) as walk:
        a = _meta(1024, dtype=torch.float32)

        def fn():
            b = a * 2           # 4 KiB live
            c = b + 1           # 8 KiB live
            del b
            return c * 3        # c and the result: 8 KiB
        out = walk.run(fn, (a,))
    assert out.shape == (1024,)
    assert walk.peak[0] == 4096 + 8192
    assert walk.live[0] == 4096 + 4096


def test_walk_refuses_tensors_that_are_not_meta():
    """An argument, an op's operand or a kernel's operand on the CPU
    raises; outside a walk the same kernel call runs its plain version."""
    cpu = torch.zeros((4, 4))
    with Walk(1) as walk:
        with pytest.raises(WalkError, match="meta tensors only"):
            walk.run(lambda: cpu * 2, (cpu,))
        m = _meta(4, 4)
        with pytest.raises(WalkError, match="meta tensors only"):
            walk.run(lambda: m.float() + cpu, (m,))
        q, k = torch.zeros((1, 2, 8, 64)), torch.zeros((1, 2, 8, 64))
        with pytest.raises(WalkError, match="meta tensors only"):
            walk.run(lambda: ops.flash_attention(q, k, k))
    out = ops.flash_attention(q, k, k)
    assert out.shape == q.shape and out.device.type == "cpu"
    with pytest.raises(RuntimeError, match="enter the walk"):
        Walk(1).run(lambda: None)
