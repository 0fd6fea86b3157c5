"""The port's training substrates against the JAX package, on the CPU:

* the data pipeline: ``make_batch`` bitwise equal to the reference's for
  every family (the vlm's ``patch_embeds``, the encdec's ``src_embeds``
  included), ``batch_specs`` and ``batch_logical_axes`` field for field;
* AdamW: the reference's ``tests/test_substrates.py`` assertions run on
  the port, one ``apply_updates`` of a mixed tree against the reference's
  (fp32, rtol 1e-6: the same operations in the same order, one rounding
  of ``b ** step`` apart at most), the cosine schedule at every step of a
  run, and the decayed set leaf for leaf against ``_decay_mask`` for every
  family;
* the error-feedback compression at one DP rank (bf16 and int8) against
  the reference's, bitwise: the same elementwise fp32 operations;
* ``CheckpointManager`` round trips of a ``TrainState``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_contract import one_thread, PORTED_ARCHS

from repro.configs import TrainConfig as JTrainConfig
from repro.configs import get_config as jget_config
from repro.data import pipeline as jpipe
from repro.models import build_model, split_params
from repro.optim import adamw as jadamw
from repro.optim import compress as jcompress
from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import TrainConfig, get_config
from repro_torch.data import pipeline as tpipe
from repro_torch.launch.train import TrainState, train_state
from repro_torch.optim import adamw as tadamw
from repro_torch.optim import compress as tcompress
from repro_torch.weights import init_params, jax_path

pytestmark = pytest.mark.usefixtures("one_thread")

#: one arch of each family
FAMILY_ARCHS = ("llama3.2-3b", "deepseek-moe-16b", "paligemma-3b",
                "mamba2-780m", "zamba2-2.7b", "seamless-m4t-medium")


# ---------------------------------------------------------------------------
# data pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", FAMILY_ARCHS)
@pytest.mark.parametrize("reduced", [True, False])
def test_make_batch_bitwise(arch, reduced):
    """The same numpy code on the same seed: every field bitwise, at the
    reduced and the full configs (the full vocab and d_model)."""
    jc, tc = jget_config(arch), get_config(arch)
    if reduced:
        jc, tc = jc.reduced(), tc.reduced()
    seq = 64 if reduced else 288
    for step in (0, 7):
        want = jpipe.make_batch(jc, 2, seq, step)
        got = tpipe.make_batch(tc, 2, seq, step)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            assert got[k].shape == want[k].shape, k
            assert got[k].tobytes() == want[k].tobytes(), (arch, k, step)


def test_make_batch_data_config_and_iterator():
    jc, tc = jget_config("yi-6b").reduced(), get_config("yi-6b").reduced()
    dc_j = jpipe.DataConfig(seed=3, mean_doc_len=32, eos_id=1)
    dc_t = tpipe.DataConfig(seed=3, mean_doc_len=32, eos_id=1)
    assert dataclasses.asdict(dc_j) == dataclasses.asdict(dc_t)
    it_j = jpipe.data_iterator(jc, 2, 48, start_step=5, data_cfg=dc_j)
    it_t = tpipe.data_iterator(tc, 2, 48, start_step=5, data_cfg=dc_t)
    for _ in range(3):
        a, b = next(it_j), next(it_t)
        assert all(a[k].tobytes() == b[k].tobytes() for k in a)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_batch_specs_and_axes_match_reference(arch):
    jc, tc = jget_config(arch).reduced(), get_config(arch).reduced()
    want = jpipe.batch_specs(jc, 4, 64)
    got = tpipe.batch_specs(tc, 4, 64)
    assert sorted(got) == sorted(want)
    for k, spec in want.items():
        shape, dtype = got[k]
        assert shape == tuple(spec.shape)
        assert str(dtype).split(".")[-1] == jnp.dtype(spec.dtype).name
    assert tpipe.batch_logical_axes(tc) == jpipe.batch_logical_axes(jc)
    batch = tpipe.make_batch(tc, 4, 64, 0)
    for k, (shape, dtype) in got.items():
        assert batch[k].shape == shape


def test_packed_batches_have_eos_and_valid_ranges():
    """The reference's pipeline test, run on the port."""
    cfg = get_config("yi-6b").reduced()
    b = tpipe.make_batch(cfg, 4, 256, step=3)
    assert b["tokens"].shape == (4, 256)
    assert b["tokens"].min() >= 0
    assert b["tokens"].max() < cfg.vocab_size
    assert (b["tokens"] == 1).any()
    full = tpipe.make_batch(cfg, 4, 256, step=3)
    np.testing.assert_array_equal(b["labels"][:, :-1], full["tokens"][:, 1:])


# ---------------------------------------------------------------------------
# AdamW: the reference's assertions on the port
# ---------------------------------------------------------------------------

def test_adamw_matches_reference_math():
    """One step vs a hand-rolled numpy AdamW."""
    tcfg = TrainConfig(learning_rate=1e-2, warmup_steps=1, total_steps=100,
                       weight_decay=0.1, grad_clip=1e9)
    w0 = np.asarray([[1.0, -2.0], [0.5, 3.0]], np.float32)
    g = np.asarray([[0.1, 0.2], [-0.3, 0.4]], np.float32)
    params = {"w": torch.tensor(w0)}
    state = tadamw.init_state(params)
    new_p, new_state, _ = tadamw.apply_updates(
        params, {"w": torch.tensor(g)}, state, tcfg)
    lr = float(tadamw.cosine_schedule(tcfg, 1.0))
    m1 = 0.1 * g
    v1 = 0.05 * g * g
    delta = (m1 / (1 - 0.9)) / (np.sqrt(v1 / (1 - 0.95)) + 1e-8) + 0.1 * w0
    np.testing.assert_allclose(new_p["w"].numpy(), w0 - lr * delta,
                               rtol=1e-5)
    assert int(new_state.step) == 1


def test_no_decay_for_norm_and_bias_params():
    tcfg = TrainConfig(learning_rate=1e-2, warmup_steps=1, weight_decay=1.0,
                       grad_clip=1e9)
    params = {"layer.norm": torch.ones(4), "layer.w": torch.ones(4)}
    grads = {k: torch.zeros(4) for k in params}
    new_p, _, _ = tadamw.apply_updates(params, grads,
                                       tadamw.init_state(params), tcfg)
    assert float((new_p["layer.norm"] - 1).abs().max()) < 1e-6
    assert float(new_p["layer.w"][0]) < 1.0


def test_grad_clip():
    grads = {"a": torch.full((10,), 10.0)}
    clipped, norm = tadamw.clip_by_global_norm(grads, 1.0)
    assert abs(float(torch.linalg.norm(clipped["a"])) - 1.0) < 1e-5
    assert float(norm) > 30


def test_cosine_schedule_shape_and_values():
    tcfg = TrainConfig(learning_rate=1.0, warmup_steps=10, total_steps=100)
    lrs = [float(tadamw.cosine_schedule(tcfg, s)) for s in
           [0, 5, 10, 55, 100]]
    assert lrs[0] < lrs[1] < lrs[2]
    assert lrs[2] >= lrs[3] >= lrs[4]
    assert lrs[4] >= 0.1 * 0.99
    # every step of an 8-step run, against the reference, in fp32: the
    # same operations (cos of an fp32 argument may differ by one ulp)
    for cfg in (TrainConfig(total_steps=8, warmup_steps=1),
                TrainConfig(total_steps=30, warmup_steps=3,
                            learning_rate=3e-3)):
        jcfg = JTrainConfig(**dataclasses.asdict(cfg))
        for s in range(cfg.total_steps + 2):
            got = float(tadamw.cosine_schedule(cfg, float(s)))
            want = float(jadamw.cosine_schedule(jcfg, jnp.float32(s)))
            assert got == pytest.approx(want, rel=1e-6, abs=0), s


def test_apply_updates_matches_reference():
    """Three ``apply_updates`` calls of a tree with decayed and undecayed,
    1-D and 2-D leaves and a clip that binds, against the reference's:
    rtol 1e-6 / atol 1e-9 (fp32, the same operations in the same order;
    ``b ** step`` and the clip's norm may round one ulp apart)."""
    rng = np.random.default_rng(0)
    names = {"layers.0.wq": ("layers", "attn", "wq"),
             "layers.0.ln1": ("layers", "ln1"),
             "final_norm": ("final_norm",),
             "layers.0.dt_bias": ("layers", "dt_bias"),
             "embed": ("embed",)}
    shapes = {"layers.0.wq": (8, 4), "layers.0.ln1": (8,),
              "final_norm": (8,), "layers.0.dt_bias": (3,),
              "embed": (16, 8)}
    p0 = {n: rng.standard_normal(shapes[n]).astype(np.float32)
          for n in names}
    cfg = TrainConfig(learning_rate=1e-2, warmup_steps=2, total_steps=10,
                      grad_clip=0.5)
    jcfg = JTrainConfig(**dataclasses.asdict(cfg))

    def nest(flat):
        tree = {}
        for n, path in names.items():
            node = tree
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = jnp.asarray(flat[n])
        return tree

    def flat_of(tree):
        out = {}
        for n, path in names.items():
            a = tree
            for k in path:
                a = a[k]
            out[n] = np.asarray(a)
        return out

    tparams = {n: torch.tensor(a) for n, a in p0.items()}
    tstate = tadamw.init_state(tparams)
    jparams = nest(p0)
    jstate = jadamw.init_state(jparams)
    for step in range(3):
        g = {n: rng.standard_normal(shapes[n]).astype(np.float32)
             for n in names}
        jparams, jstate, jm = jadamw.apply_updates(jparams, nest(g), jstate,
                                                   jcfg)
        tparams, tstate, tm = tadamw.apply_updates(
            tparams, {n: torch.tensor(a) for n, a in g.items()}, tstate, cfg)
        want = flat_of(jparams)
        for n in names:
            np.testing.assert_allclose(tparams[n].numpy(), want[n],
                                       rtol=1e-6, atol=1e-9)
        for mine, theirs in ((tstate.m, jstate.m), (tstate.v, jstate.v)):
            ref = flat_of(theirs)
            for n in names:
                np.testing.assert_allclose(mine[n].numpy(), ref[n],
                                           rtol=1e-6, atol=1e-12)
        assert int(tstate.step) == int(jstate.step) == step + 1
        for k in ("grad_norm", "lr"):
            assert float(tm[k]) == pytest.approx(float(jm[k]), rel=1e-6)


@pytest.mark.parametrize("arch", PORTED_ARCHS)
def test_decayed_set_matches_reference(arch):
    """The port's decay decision of every parameter equals the reference's
    ``_decay_mask`` at its JAX path, for every config (``ln1`` / ``ln2`` /
    ``ln_x``, the QKV biases and ``conv_b`` decayed; the norms,
    ``dt_bias``, ``A_log`` and ``D`` not), and every reference leaf is
    some port parameter's."""
    jc = jget_config(arch).reduced()
    params, _ = split_params(build_model(jc).init_params(jax.random.key(0)))
    mask = jadamw._decay_mask(params)
    want = {"/".join(str(getattr(k, "key", k)) for k in path): bool(leaf)
            for path, leaf in jax.tree_util.tree_leaves_with_path(mask)}
    model = init_params(get_config(arch).reduced(), 0, "cpu")
    got = {}
    for n, _ in model.named_parameters():
        path = "/".join(jax_path(n)[0])
        assert got.setdefault(path, tadamw.decays(n)) == tadamw.decays(n)
    assert got == want
    names = [n for n, _ in model.named_parameters()]
    assert any(tadamw.decays(n) for n in names)
    assert not any(tadamw.decays(n) for n in names
                   if n.endswith(("final_norm", "A_log", "dt_bias", ".D",
                                  "gate_norm")))


# ---------------------------------------------------------------------------
# error-feedback compression at one DP rank
# ---------------------------------------------------------------------------

def test_bf16_error_feedback_is_unbiased_over_time():
    """The reference's test on the port: sum of compressed values plus
    the final residual equals the sum of the true values."""
    rng = np.random.default_rng(0)
    g_true = [torch.tensor(rng.standard_normal((64,)) * 1e-3,
                           dtype=torch.float32) for _ in range(20)]
    err = torch.zeros(64)
    total = torch.zeros(64)
    for g in g_true:
        (sent,), (err,) = tcompress.compress_psum_bf16((g,), (err,), (), 1)
        total = total + sent
    want = sum(g.double().numpy() for g in g_true)
    assert np.abs((total + err).double().numpy() - want).max() < 1e-5


def test_int8_quantization_bounded_error():
    g = torch.tensor(np.random.default_rng(1).standard_normal((128,)),
                     dtype=torch.float32)
    (out,), (err,) = tcompress.compress_psum_int8((g,), (torch.zeros(128),),
                                                  (), 1)
    scale = float(g.abs().max()) / 127
    assert float((out - g).abs().max()) <= scale * 0.5 + 1e-6
    np.testing.assert_allclose((out + err).numpy(), g.numpy(), atol=1e-6)


@pytest.mark.parametrize("kind", ["bf16", "int8"])
def test_compression_matches_reference(kind):
    """Ten rounds of feedback on a dict of grads against the reference's,
    bitwise: the same fp32 operations, elementwise."""
    rng = np.random.default_rng(2)
    tfn = getattr(tcompress, f"compress_psum_{kind}")
    jfn = getattr(jcompress, f"compress_psum_{kind}")
    shapes = {"a": (16, 8), "b": (33,)}
    terr = tcompress.init_error_state(
        {k: torch.zeros(s) for k, s in shapes.items()})
    jerr = jcompress.init_error_state(
        {k: jnp.zeros(s) for k, s in shapes.items()})
    for _ in range(10):
        g = {k: (rng.standard_normal(s) * 1e-2).astype(np.float32)
             for k, s in shapes.items()}
        tout, terr = tfn({k: torch.tensor(v) for k, v in g.items()}, terr,
                         (), 1)
        jout, jerr = jfn({k: jnp.asarray(v) for k, v in g.items()}, jerr,
                         (), 1)
        for k in shapes:
            assert tout[k].numpy().tobytes() == \
                np.asarray(jout[k]).tobytes(), k
            assert terr[k].numpy().tobytes() == \
                np.asarray(jerr[k]).tobytes(), k


def test_compression_over_dp_axes_takes_one_tree_per_rank():
    """Over DP axes the call takes a ``mesh`` and one tree per rank (what
    replaced its refusal; without a mesh it still raises): each rank gets
    the mean of its DP group's compressed grads, and keeps its own
    residual (the reference's ``shard_map`` is held in
    ``tests/test_torch_mesh_elastic.py``)."""
    from repro_torch.launch.mesh import make_test_mesh
    g = (torch.ones(4),)
    for fn in (tcompress.compress_psum_bf16, tcompress.compress_psum_int8):
        with pytest.raises(ValueError, match="mesh="):
            fn(g, g, ("data",), 2)
    mesh = make_test_mesh((2, 2), ("data", "model"), devices="cpu")
    rng = np.random.default_rng(1)
    grads = [(torch.tensor(rng.standard_normal(6), dtype=torch.float32),)
             for _ in range(4)]
    zero = [(torch.zeros(6),) for _ in range(4)]
    out, err = tcompress.compress_psum_bf16(grads, zero, ("data",), 2,
                                            mesh=mesh)
    for r, partner in ((0, 2), (1, 3), (2, 0), (3, 1)):
        want = (grads[r][0].bfloat16().float() +
                grads[partner][0].bfloat16().float()).bfloat16().float() / 2
        assert torch.equal(out[r][0], want)
        assert torch.equal(err[r][0], grads[r][0] -
                           grads[r][0].bfloat16().float())
    out8, _ = tcompress.compress_psum_int8(grads, zero, ("data", "model"), 4,
                                           mesh=mesh)
    mean = sum(t[0] for t in grads) / 4
    scale = max(float(t[0].abs().max()) for t in grads) / 127
    for r in range(4):
        assert torch.equal(out8[r][0], out8[0][0])
        assert float((out8[r][0] - mean).abs().max()) <= scale


# ---------------------------------------------------------------------------
# checkpoints of a TrainState
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("async_save", [True, False])
def test_train_state_checkpoint_roundtrip(tmp_path, async_save):
    """A ``TrainState`` (a NamedTuple of a parameter dict and an
    ``AdamWState``) comes back with its structure, dtypes, devices and
    values, the step included."""
    model = init_params(get_config("zamba2-2.7b").reduced(), 0, "cpu",
                        param_dtype=torch.float32)
    state = train_state(model)
    for i, t in enumerate(state.opt.m.values()):
        t.fill_(i * 0.5)
    state.opt.step.fill_(7)
    ckpt = CheckpointManager(str(tmp_path), async_save=async_save)
    ckpt.save(3, state)
    restored, step = ckpt.restore(state)
    assert step == 3 and isinstance(restored, TrainState)
    assert isinstance(restored.opt, tadamw.AdamWState)
    assert int(restored.opt.step) == 7
    assert restored.opt.step.dtype == torch.int32
    assert restored.opt.step.shape == ()
    for a, b in ((state.params, restored.params), (state.opt.m,
                                                   restored.opt.m),
                 (state.opt.v, restored.opt.v)):
        assert list(a) == list(b)
        for n in a:
            assert b[n].dtype == a[n].dtype and b[n].device == a[n].device
            assert torch.equal(b[n], a[n].detach()), n
