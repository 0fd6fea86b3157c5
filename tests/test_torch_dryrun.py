"""The port's dry-run (``repro_torch/launch/dryrun.py``, the counterpart of
``repro/launch/dryrun.py``), on the CPU over ``meta`` tensors.

* One reduced cell per family and kind (train, prefill, decode) walks to
  ``status == "ok"`` over a (2, 2) mesh, with the kernels each path
  reaches counted at their boundary (K3 in prefill, K4 in the ssm and
  hybrid prefill, K2 in decode, none in training).
* Skips follow the reference's ``shape_applicable``.
* The decode cell's declared appends equal what the engine's path reads
  from the block table, and a decode step given them returns what the
  step without them returns.
* A production-mesh row carries the reference's keys, and
  ``benchmarks/roofline.py table`` reads it; the CLI writes and resumes.
"""
import json

import numpy as np
import pytest
import torch

from repro_torch.configs import (SHAPES, ShapeConfig, get_config, list_archs,
                                 shape_applicable)
from repro_torch.launch.dryrun import (MESH_NAMES, analyse, declared_appends,
                                       main, run_cell, walk_cell)
from repro_torch.launch.mesh import make_production_mesh, make_test_mesh

#: one arch of each family
FAMILIES = {"dense": "llama3.2-3b", "moe": "deepseek-moe-16b",
            "vlm": "paligemma-3b", "ssm": "mamba2-780m",
            "hybrid": "zamba2-2.7b", "encdec": "seamless-m4t-medium"}

#: the kernels each (family, kind) reaches, and their calls over 2 x 2
#: ranks at the reduced depth
KERNELS = {("dense", "prefill"): {"K3": 4}, ("moe", "prefill"): {"K3": 4},
           ("vlm", "prefill"): {"K3": 4}, ("ssm", "prefill"): {"K4": 4},
           ("hybrid", "prefill"): {"K4": 4, "K3": 2},
           ("encdec", "prefill"): {"K3": 10},
           ("dense", "decode"): {"K2": 16}, ("moe", "decode"): {"K2": 16},
           ("vlm", "decode"): {"K2": 16}, ("ssm", "decode"): {},
           ("hybrid", "decode"): {"K2": 8},
           ("encdec", "decode"): {"K2": 16, "K3": 4}}

#: the reference's row keys (``analyse`` and ``run_cell``)
REF_KEYS = {"arch", "shape", "mesh", "status", "lower_s", "compile_s",
            "hlo_flops_per_dev", "hlo_bytes_per_dev", "xla_flops_onepass",
            "collectives", "memory", "t_compute_s", "t_memory_s",
            "t_collective_s", "dominant", "model_flops_per_dev",
            "useful_flop_ratio", "roofline_fraction"}
MEMORY_KEYS = {"argument_size_in_bytes", "output_size_in_bytes",
               "temp_size_in_bytes", "generated_code_size_in_bytes",
               "alias_size_in_bytes"}


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_reduced_cell_of_every_family(family, kind):
    """The family's reduced config at B = 4, S = 128 over (2, 2) ranks:
    the walk ends, its kernels are the path's, every rank holds
    arguments, and the terms are positive."""
    cfg = get_config(FAMILIES[family]).reduced()
    shape = ShapeConfig(kind, 128, 4, kind)
    mesh = make_test_mesh((2, 2), devices="meta")
    walk, _, _ = walk_cell(cfg, shape, mesh)
    row = analyse(walk, cfg, shape, mesh.size)
    got = {k: v["calls"] for k, v in row["kernels"].items()}
    assert got == KERNELS.get((family, kind), {})
    assert row["hlo_flops_per_dev"] > 0 and row["hlo_bytes_per_dev"] > 0
    assert row["memory"]["argument_size_in_bytes"] > 0
    assert row["memory"]["temp_size_in_bytes"] >= 0
    assert row["model_flops_per_dev"] == pytest.approx(
        (6 if kind == "train" else 2) * cfg.active_param_count()
        * 4 * (1 if kind == "decode" else 128) / 4)
    if kind == "train":
        # the masters, moments and batch are placed over the ranks
        assert min(walk.arguments) > 0


def test_skips_follow_the_reference():
    """Every (arch, shape) the reference's ``shape_applicable`` skips is a
    skip row with its reason, and no other; the port's rule is the
    reference's."""
    from repro.configs import SHAPES as JSHAPES
    from repro.configs import get_config as jget_config
    from repro.configs import shape_applicable as jshape_applicable
    assert list(SHAPES) == list(JSHAPES)
    n_skip = 0
    for arch in list_archs():
        for name in SHAPES:
            ok, reason = jshape_applicable(jget_config(arch), JSHAPES[name])
            assert (ok, reason) == shape_applicable(get_config(arch),
                                                    SHAPES[name])
            if not ok:
                row = run_cell(arch, name, False)
                assert row == {"arch": arch, "shape": name, "mesh": "16x16",
                               "status": "skip", "reason": reason}
                n_skip += 1
    assert n_skip == 8


def test_declared_appends_equal_the_engine_path():
    """The appends the decode cell declares equal ``rank_appends`` of
    ``append_slots`` over the same layout, and a decode step given them
    returns what it returns without them (the engine's path)."""
    from repro_torch.models.lm import append_slots, paged_state
    from repro_torch.models.paged import identity_layout, rank_appends
    from repro_torch.weights import init_params
    cfg = get_config("llama3.2-3b").reduced()
    model = init_params(cfg, seed=0, device="cpu")
    B, S, page = 4, 128, model.page
    mesh = make_test_mesh((1, 4), devices="cpu")
    state = paged_state(cfg, B, S, page, mesh, torch.float32, "cpu")
    gen = torch.Generator().manual_seed(0)
    for slabs in (state["k_pools"], state["v_pools"]):
        for s in slabs:
            s.copy_(torch.randn(s.shape, generator=gen))
    fill = S - 1
    seq_lens = torch.full((B,), fill, dtype=torch.int32)
    sizes = [s.shape[1] for s in state["k_pools"]]
    table = identity_layout(B, S, page)[0]
    mine = declared_appends(table, fill, page, sizes, "cpu")
    theirs = rank_appends(*append_slots(seq_lens.long(),
                                        state["block_table"], page), sizes)
    for a, b in zip(mine, theirs):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    tokens = torch.tensor([3, 5, 7, 9])
    outs = []
    for appends in (None, mine):
        pools = [[s.clone() for s in state[n]] for n in ("k_pools",
                                                         "v_pools")]
        outs.append(model.decode_step(
            tokens, seq_lens, *pools, state["block_table"],
            state["share_mask"], state["base"], mesh=mesh, appends=appends))
    assert torch.equal(outs[0], outs[1])


def test_production_mesh_and_row_keys(tmp_path):
    """``make_production_mesh`` gives the reference's meshes; a
    production-mesh row (mamba2-780m's 500k decode over 16 x 16 ranks)
    carries every key of the reference's rows and ``roofline.py``'s
    ``table`` reads it; the CLI appends the row and ``--resume`` skips
    it."""
    from benchmarks.roofline import table
    single, multi = (make_production_mesh(multi_pod=m) for m in (False,
                                                                 True))
    assert (single.shape, single.axis_names) == ((16, 16), ("data", "model"))
    assert (multi.shape, multi.axis_names) == ((2, 16, 16),
                                               ("pod", "data", "model"))
    assert {d.type for d in multi.devices} == {"meta"}
    assert MESH_NAMES == {False: "16x16", True: "2x16x16"}
    out = tmp_path / "rows.jsonl"
    argv = ["--arch", "mamba2-780m", "--shape", "long_500k", "--mesh",
            "single", "--out", str(out)]
    main(argv)
    main(argv + ["--resume"])
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert len(rows) == 1 and rows[0]["status"] == "ok", rows
    row = rows[0]
    assert REF_KEYS <= set(row) and MEMORY_KEYS == set(row["memory"])
    assert row["dominant"] in ("compute", "memory", "collective")
    # an ssm decode runs whole on the first rank: it is the busiest
    assert row["busiest_rank"] == 0 and row["kernels"] == {}
    t, = table(rows)
    assert t["status"] == "ok" and t["temp_gib"] >= 0
    assert t["t_memory_ms"] == pytest.approx(row["t_memory_s"] * 1e3)
    assert np.isfinite(row["roofline_fraction"])
