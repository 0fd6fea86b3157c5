"""The port's sharding rules (``repro_torch/sharding/rules.py``) against
the reference's (``repro/sharding/rules.py``): the two rule tables, every
logical name of both resolved over the six meshes of
``tests/test_torch_mesh_serve.py::test_mesh_arithmetic_matches_reference``
with dims that divide and dims that do not, names that compete for one
mesh axis, ``use_rules`` nesting, ``attn_strategy`` and ``axis_size``.  The reference's ``PartitionSpec`` is
read as a tuple; its rules read only a mesh's ``axis_names`` and
``shape``, so the JAX side needs no forced devices.
"""
import types

import pytest

import repro.sharding.rules as jrules
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.sharding import rules

MESHES = [((2, 4), ("data", "model")), ((4,), ("model",)), ((4,), ("data",)),
          ((2, 2, 2), ("pod", "data", "model")), ((8,), ("model",)),
          ((2, 1), ("data", "model"))]
RULE_SETS = {"default": (rules.DEFAULT_RULES, jrules.DEFAULT_RULES),
             "fsdp": (rules.FSDP_RULES, jrules.FSDP_RULES)}
#: dims that every mesh axis group divides, that some do not, and 1
DIMS = (None, 1, 2, 3, 4, 6, 8, 12, 16, 64)
#: several logical names in one spec: later names lose the axes earlier
#: ones took
MULTI = [("batch", "act_seq_tp", None), ("batch", "act_seq", "act_embed"),
         ("embed", "ffn"), ("experts", "embed", "ffn"),
         ("layers", "kv_blocks", None, None, None), ("kv_blocks", "kv_seq"),
         ("batch", "embed", "vocab"), ("norm", "ssm_inner", "conv_ch"),
         ("act_heads", "act_kv_heads", "heads"), ("replicated", "unknown")]


def pair(shape, axes):
    return (make_test_mesh(shape, axes, devices="cpu"),
            types.SimpleNamespace(axis_names=tuple(axes),
                                  shape=dict(zip(axes, shape))))


def test_rule_tables_equal_the_reference():
    assert rules.DEFAULT_RULES == jrules.DEFAULT_RULES
    assert rules.FSDP_RULES == jrules.FSDP_RULES


@pytest.mark.parametrize("rule_set", list(RULE_SETS))
@pytest.mark.parametrize("shape,axes", MESHES)
def test_logical_to_spec_matches_reference(shape, axes, rule_set):
    """Each logical name alone at every dim of ``DIMS`` (and unknown
    dims), and the multi-name specs of ``MULTI`` with every dim from
    ``DIMS`` on every position: the port's tuple equals the reference's
    ``PartitionSpec`` entries."""
    tm, jm = pair(shape, axes)
    mine, theirs = RULE_SETS[rule_set]
    for name in mine:
        for d in DIMS:
            dims = None if d is None else (d,)
            assert rules.logical_to_spec((name,), tm, mine, dims) == \
                tuple(jrules.logical_to_spec((name,), jm, theirs, dims)), \
                (name, d)
    for names in MULTI:
        for d in DIMS:
            dims = None if d is None else (d,) * len(names)
            assert rules.logical_to_spec(names, tm, mine, dims) == \
                tuple(jrules.logical_to_spec(names, jm, theirs, dims)), \
                (names, d)


@pytest.mark.parametrize("shape,axes", MESHES)
def test_mesh_helpers_match_reference(shape, axes):
    """``attn_strategy`` over head counts and ``axis_size`` of every axis,
    absent ones and groups."""
    tm, jm = pair(shape, axes)
    for heads in (1, 3, 4, 8, 16, 24, 32):
        assert rules.attn_strategy(heads, tm) == \
            jrules.attn_strategy(heads, jm)
    for ax in ("pod", "data", "model", ("pod", "data"),
               ("pod", "data", "model"), ("data", "model"), "other"):
        assert rules.axis_size(tm, ax) == jrules.axis_size(jm, ax)


def test_use_rules_nests_like_the_reference():
    """``use_rules`` stacks: the innermost set is active, leaving a block
    restores the one outside, and no block means ``DEFAULT_RULES``; the
    same names resolve as the reference's under the same nesting (the
    batch over every axis under FSDP, over (pod, data) otherwise)."""
    tm, jm = pair((2, 2, 2), ("pod", "data", "model"))

    def both():
        return (rules.logical_to_spec(("batch", "act_seq_tp"), tm),
                tuple(jrules.logical_to_spec(("batch", "act_seq_tp"), jm)))

    assert rules.active_rules() is rules.DEFAULT_RULES
    outer = both()
    assert outer[0] == outer[1] == (("pod", "data"), "model")
    with rules.use_rules(rules.FSDP_RULES) as r, \
            jrules.use_rules(jrules.FSDP_RULES):
        assert r is rules.FSDP_RULES is rules.active_rules()
        fsdp = both()
        assert fsdp[0] == fsdp[1] == (("pod", "data", "model"), None)
        with rules.use_rules(rules.DEFAULT_RULES), \
                jrules.use_rules(jrules.DEFAULT_RULES):
            assert both() == outer
        assert both() == fsdp
    assert rules.active_rules() is rules.DEFAULT_RULES
    assert both() == outer


def test_moe_path_follows_the_active_rules():
    """Under ``FSDP_RULES`` (``act_seq_tp`` unsharded) a ``model`` mesh
    sends the moe FFN down the FSDP path where the default rules send it
    through the all-to-all, as the reference's ``moe_ffn`` reads
    ``active_rules()``."""
    from repro_torch.configs import get_config
    from repro_torch.models import moe
    cfg = get_config("deepseek-moe-16b").reduced()
    tm = make_test_mesh((4,), ("model",), devices="cpu")
    assert moe.moe_path(tm, (4, 64, 128), cfg) == "a2a"
    with rules.use_rules(rules.FSDP_RULES):
        assert moe.moe_path(tm, (4, 64, 128), cfg) == "fsdp"
        assert moe.moe_path(tm, (2, 64, 128), cfg) == "local"
    assert moe.moe_path(None, (4, 64, 128), cfg) == "local"
    assert moe.moe_path(make_test_mesh((1,), ("model",), devices="cpu"),
                        (4, 64, 128), cfg) == "local"
