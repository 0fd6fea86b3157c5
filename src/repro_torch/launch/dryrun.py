"""Production-mesh dry-run of the port (port of ``repro/launch/dryrun.py``):
every (arch x shape x mesh) cell reckoned on ``meta`` tensors over the
reference's production meshes, (16, 16) and (2, 16, 16) ranks, with each
rank's memory, FLOPs, HBM bytes and peer bytes and the resulting
compute / memory / peer roofline against one H100's published peaks.

The reference lowers and compiles each cell on 512 placeholder host
devices and reads XLA's HLO (``hlo_analysis.py``); the port runs the
cell's step itself under the op-cost walk (``launch/op_cost.py``), which
counts every op per rank, and every kernel call of K1-K7 at its boundary
by ``kernels/cost.py``.  Nothing is allocated: parameters, batches and
serve states are ``meta`` tensors, made without a random draw.  This is
the one entry point that needs no card; every other runs on the card
unless asked for the CPU.  Every number it writes is a reckoning against
the published peaks (``kernels/cost.py``), not a measurement.

A cell is the reference's: train the fp32 masters placed by
``build_train_step``'s ``shard_state`` and ``train_state`` over a batch of
``data.batch_specs`` placed by its ``batch_shardings`` (``TrainConfig()``,
``"fsdp"``), the step computing every block of the loss and its backward
on the rank that holds it (each rank's ZeRO-3 gathers count to
``"gather"``, the loss's partial sums to ``"loss"``); prefill the bf16
weights' ``prefill(tokens, mesh=)`` (``prefill_state`` for the vlm, ssm,
hybrid and encdec families), every family's weights placed over the mesh
by ``weights.place_params`` as the reference's ``tree_shardings`` places
them (``p_sh16``); decode one ``decode_step`` (``decode_state``) over an
identity-layout serve state whose every slot holds a sequence at
``seq_len - 1`` tokens, a facade's recurrent and cross leaves placed by
``state_logical_axes`` (the reference's ``st_sh``), with the step's
appends taken from that declared layout (the port reads them from the
block table otherwise).  The moves count as peer bytes by their paths:
``"gather"`` (a weight's ZeRO-3 dimension, a K/V row range), ``"sum"``
(the row-parallel partial sums), ``"all-to-all"`` (a moe FFN's
dispatch), ``"pages"`` (a facade prefill's K/V into the slabs), and a
Mamba2 layer's ``"ssm_columns"`` (the ``w_in`` product's column joins),
``"ssm_bc"`` (the B / C gathers) and ``"gate_norm"`` (the gate norm's
sums of squares).  Rows carry
the reference's keys (``benchmarks/roofline.py table`` reads them) and
the port's ``busiest_rank``, ``temp_range_bytes`` (the least and the most
temporary bytes of any rank), ``kernels`` and ``ops``; the "collective"
term is the busiest rank's peer bytes over NVLink.

CLI:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3.2-3b \\
        --shape train_4k --mesh single [--out results/dryrun_torch.jsonl]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh single
"""
from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.configs import (SHAPES, ModelConfig, ShapeConfig,
                                 TrainConfig, get_config, list_archs,
                                 shape_applicable)
from repro_torch.data import batch_logical_axes, batch_specs
from repro_torch.kernels import cost
from repro_torch.launch.mesh import DeviceMesh, make_production_mesh, place
from repro_torch.launch.op_cost import Walk
from repro_torch.launch.train import build_train_step, train_state
from repro_torch.models.lm import ENTRY_PAIRS, LanguageModel, paged_state
from repro_torch.models.paged import identity_layout
from repro_torch.weights import params_axes, place_params

#: the mesh names of the reference's rows
MESH_NAMES = {False: "16x16", True: "2x16x16"}


def _empty(shape, dtype, device) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=device)


def declared_appends(table: np.ndarray, fill: int, page: int,
                     slab_sizes, device) -> list:
    """``paged.rank_appends(*lm.append_slots(...))`` of a decode step over
    ``table`` where every slot holds a sequence at ``fill`` tokens, from
    the host layout: per slab, in shard order, (rows, slab-local block
    ids, offsets) on ``device``."""
    B = table.shape[0]
    rows = np.arange(B, dtype=np.int64)
    ids = table[:, fill // page].astype(np.int64)
    offs = np.full(B, fill % page, np.int64)
    starts = np.cumsum([0, *slab_sizes[:-1]])
    rank = np.searchsorted(starts[1:], ids, side="right")
    out = []
    for r in range(len(slab_sizes)):
        sel = rank == r
        out.append(tuple(torch.from_numpy(a).to(device) for a in
                         (rows[sel], ids[sel] - starts[r], offs[sel])))
    return out


def build_cell(arch: Union[str, ModelConfig],
               shape: Union[str, ShapeConfig], mesh: DeviceMesh,
               tcfg: Optional[TrainConfig] = None
               ) -> Tuple[Callable[[], object], object]:
    """``(fn, arguments)`` of one cell on ``mesh`` (its ranks on
    ``meta``): ``fn()`` runs the cell's step, ``arguments`` holds what
    the reference passes the compiled step (the state, the weights, the
    batch).  ``tcfg``: a train cell's ``TrainConfig`` (default the
    reference's ``TrainConfig()``).  Build it inside an active
    :class:`~repro_torch.launch.op_cost.Walk`, which places the tensors on
    their ranks."""
    cfg = get_config(arch) if isinstance(arch, str) else arch
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    dev = mesh.devices[0]
    B, S = shape.global_batch, shape.seq_len
    if shape.kind == "train":
        model = LanguageModel(cfg, dev, param_dtype=torch.float32)
        step, shard_state, batch_shardings = build_train_step(
            model, tcfg or TrainConfig(), mesh, params_axes(model),
            batch_logical_axes(cfg))
        state = train_state(model, shard_state(dict(model.named_parameters())))
        batch = {k: _empty(s, dt, dev)
                 for k, (s, dt) in batch_specs(cfg, B, S).items()}
        batch = {k: place(v, batch_shardings(batch)[k])
                 for k, v in batch.items()}
        return (lambda: step(state, batch)), (state, batch)

    # the reference's p_sh16 = tree_shardings(mesh, params_bf16, axes)
    model = place_params(LanguageModel(cfg, dev), mesh)
    weights = model.placement.values
    facade = cfg.family in ENTRY_PAIRS["prefill_state / decode_state"]
    if shape.kind == "prefill":
        batch = {k: _empty(s, torch.long if dt == torch.int32 else dt, dev)
                 for k, (s, dt) in batch_specs(cfg, B, S).items()
                 if k not in ("labels", "mask")}
        tokens = batch["tokens"]
        if not facade:
            return (lambda: model.prefill(tokens, mesh=mesh)), \
                (weights, batch)
        return (lambda: model.prefill_state(
            tokens, patch_embeds=batch.get("patch_embeds"),
            src_embeds=batch.get("src_embeds"), mesh=mesh)), \
            (weights, batch)

    # decode: one step over the identity layout at fill seq_len - 1
    fill = S - 1
    tokens = _empty((B,), torch.long, dev)
    if facade:
        # placed by state_logical_axes (the reference's st_sh)
        state = model.make_serve_state(B, S, mesh=mesh)
    else:
        state = paged_state(cfg, B, S, model.page, mesh, model.act_dtype, dev)
        state["seq_lens"] = torch.full((B,), fill, dtype=torch.int32,
                                       device=dev)
    appends = None
    if cfg.num_attn_layers:
        ks = state["k_pools"]
        sizes = [s.shape[1] for s in (ks if isinstance(ks, list) else [ks])]
        table = identity_layout(B, S, model.page)[0]
        appends = declared_appends(table, fill, model.page, sizes, dev)
    if facade:
        return (lambda: model.decode_state(state, tokens, mesh=mesh,
                                           appends=appends)), \
            (weights, state, tokens)
    return (lambda: model.decode_step(
        tokens, state["seq_lens"], state["k_pools"], state["v_pools"],
        state["block_table"], state["share_mask"], state["base"], mesh=mesh,
        appends=appends)), (weights, state, tokens)


def analyse(walk: Walk, cfg: ModelConfig, shape: ShapeConfig,
            n_ranks: int) -> Dict:
    """The reference's roofline terms for one walked cell, on its busiest
    rank (the one whose largest term is the largest) against one H100:
    FLOPs over 989 TFLOP/s, HBM bytes over 3.35 TB/s, peer bytes over
    450 GB/s of NVLink; memory from the walk's storage lifetimes; model
    FLOPs by the reference's formula (6 N D for train, else 2 N D, over
    the ranks)."""
    r = walk.busiest()
    t = [p - a for p, a in zip(walk.peak, walk.arguments)]
    terms = walk.terms(r)
    flops, byts = walk.flops[r], walk.bytes[r]
    t_compute, t_memory, t_coll = (terms["compute"], terms["memory"],
                                   terms["collective"])
    dominant = max(terms, key=terms.get)
    n_tok = shape.global_batch * (shape.seq_len if shape.kind in
                                  ("train", "prefill") else 1)
    model_flops = 6.0 * cfg.active_param_count() * n_tok
    if shape.kind != "train":
        model_flops /= 3.0
    per_dev = model_flops / n_ranks
    worst = max(terms.values())
    coll = dict(walk.rank_paths[r])
    coll["wire_bytes"] = walk.peer[r]
    return {
        "hlo_flops_per_dev": flops,
        "hlo_bytes_per_dev": byts,
        # an eager step runs every op as counted: no loop to fold
        "xla_flops_onepass": flops,
        "collectives": coll,
        "memory": {
            "argument_size_in_bytes": walk.arguments[r],
            "output_size_in_bytes": walk.outputs[r],
            "temp_size_in_bytes": walk.peak[r] - walk.arguments[r],
            # the port compiles nothing a cell: its kernels are built once
            "generated_code_size_in_bytes": 0,
            "alias_size_in_bytes": walk.aliased[r],
        },
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "model_flops_per_dev": per_dev,
        "useful_flop_ratio": per_dev / flops if flops else 0.0,
        "roofline_fraction": per_dev / cost.BF16_FLOPS / worst
        if worst > 0 else 0.0,
        "busiest_rank": r,
        # the least and the most temporary bytes of any rank
        "temp_range_bytes": [min(t), max(t)],
        "kernels": walk.kernels,
        "ops": walk.ops,
    }


def walk_cell(arch: Union[str, ModelConfig], shape: Union[str, ShapeConfig],
              mesh: DeviceMesh) -> Tuple[Walk, float, float]:
    """Build and walk one cell; returns (the walk, build s, walk s)."""
    shape = SHAPES[shape] if isinstance(shape, str) else shape
    walk = Walk(mesh.size, fill=shape.seq_len)
    with walk:
        t0 = time.perf_counter()
        fn, arguments = build_cell(arch, shape, mesh)
        t1 = time.perf_counter()
        walk.run(fn, arguments)
    return walk, t1 - t0, time.perf_counter() - t1


def run_cell(arch: str, shape_name: str, multi_pod: bool) -> Dict:
    """Walk one (arch, shape, mesh) cell and return its row
    (status ok / skip / error, with the analysis)."""
    cfg = get_config(arch)
    shape = SHAPES[shape_name]
    ok, reason = shape_applicable(cfg, shape)
    row = {"arch": arch, "shape": shape_name, "mesh": MESH_NAMES[multi_pod]}
    if not ok:
        row.update(status="skip", reason=reason)
        return row
    mesh = make_production_mesh(multi_pod=multi_pod)
    try:
        walk, t_build, t_walk = walk_cell(cfg, shape, mesh)
        row.update(status="ok", lower_s=round(t_build, 1),
                   compile_s=round(t_walk, 1),
                   **analyse(walk, cfg, shape, mesh.size))
    except Exception as e:  # noqa: BLE001
        row.update(status="error", error=f"{type(e).__name__}: {e}",
                   traceback=traceback.format_exc()[-2000:])
    return row


def main(argv=None) -> None:
    """CLI: walk the requested (arch, shape, mesh) cells and append their
    rows to ``--out``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"],
                    default="single")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--out", default="results/dryrun_torch.jsonl")
    ap.add_argument("--resume", action="store_true",
                    help="skip cells already in --out")
    args = ap.parse_args(argv)

    archs = list_archs() if args.all or args.arch is None else [args.arch]
    shapes = list(SHAPES) if args.all or args.shape is None else [args.shape]
    meshes = {"single": [False], "multi": [True],
              "both": [False, True]}[args.mesh]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    done = set()
    if args.resume and os.path.exists(args.out):
        with open(args.out) as f:
            for line in f:
                r = json.loads(line)
                if r.get("status") in ("ok", "skip"):
                    done.add((r["arch"], r["shape"], r["mesh"]))

    with open(args.out, "a") as f:
        for arch in archs:
            for shape in shapes:
                for mp in meshes:
                    key = (arch, shape, MESH_NAMES[mp])
                    if key in done:
                        continue
                    print(f"[dryrun] {key} ...", flush=True)
                    row = run_cell(arch, shape, mp)
                    what = row.get("dominant", row.get("reason",
                                                       row.get("error", "")))
                    print(f"[dryrun] {key} -> {row['status']} {what[:120]}",
                          flush=True)
                    f.write(json.dumps(row) + "\n")
                    f.flush()


__all__ = ["MESH_NAMES", "analyse", "build_cell", "declared_appends",
           "main", "run_cell", "walk_cell"]


if __name__ == "__main__":
    main()
