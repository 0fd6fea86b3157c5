"""The port's examples (``examples/torch_*.py``) against the reference's
(``examples/*.py``), on the CPU, and the package surfaces they import.

Each reference example runs in a subprocess (``JAX_PLATFORMS=cpu``) and
its counterpart in process with ``--device cpu``, with the same flags:

* quickstart: every printed line equal (the dispatch counts, bytes and
  every ``engine.stats`` field);
* serve_cow (``--requests 2 --samples-per-request 2 --new-tokens 6``):
  every line equal but the rate line's timing and device, and the sampled
  token ids, which come from the weights (the port's are its own random
  weights from seed 0);
* train_e2e (``--steps 3 --batch 1 --seq-len 32 --fail-at 2``): every
  line equal but the checkpoint directory and the numbers that come from
  the weights; fed the reference's initial weights (``from_jax_params``),
  the port's losses are within rtol 1e-4 of the reference's
  ``train_loop`` on the same arguments (the trajectory tolerance of
  ``tests/test_torch_train_loop.py``), and so are the printed losses and
  grad norms at their printed precision.
"""
import importlib.util
import os
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from test_torch_contract import one_thread  # noqa: F401

pytestmark = pytest.mark.usefixtures("one_thread")

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"

#: the flags both sides run with (the reference's CPU-sized runs)
SERVE_ARGS = ["--requests", "2", "--samples-per-request", "2",
              "--new-tokens", "6"]
TRAIN_ARGS = ["--steps", "3", "--batch", "1", "--seq-len", "32",
              "--fail-at", "2"]
#: the train_e2e trajectory tolerance (tests/test_torch_train_loop.py)
LOSS_RTOL = 1e-4


def _reference(script: str, args=()) -> list:
    """The printed lines of a reference example run on the CPU."""
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, str(EXAMPLES / script), *args],
                         capture_output=True, text=True, cwd=ROOT, env=env,
                         timeout=600)
    assert out.returncode == 0, out.stderr
    return out.stdout.splitlines()


def _module(path: Path, name: str):
    """The module of ``path``, loaded by file path as ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _example(name: str):
    """``examples/torch_<name>.py``."""
    return _module(EXAMPLES / f"torch_{name}.py", f"torch_{name}_example")


def _port(name: str, args, capsys):
    """(the result, the printed lines) of a port example run in process
    on the CPU."""
    capsys.readouterr()
    result = _example(name).main([*args, "--device", "cpu"])
    return result, capsys.readouterr().out.splitlines()


def test_quickstart_prints_the_reference_lines(capsys):
    ref = _reference("quickstart.py")
    engine, lines = _port("quickstart", [], capsys)
    assert lines == ref
    s = engine.stats
    assert (s.launches, s.fpm_copies, s.psm_copies, s.zero_lazy,
            s.bytes_avoided) == (5, 2, 5, 10, 81920)
    assert engine.pools["k"].dtype == torch.bfloat16


def test_block_state_reads_a_bf16_pool(capsys):
    """A ticket's ``block_state`` on the quickstart's bf16 pools returns
    the block's values as float32 (numpy has no bfloat16)."""
    from repro_torch.core import BlockRef
    engine, _ = _port("quickstart", [], capsys)
    src = int(torch.nonzero(engine.pools["k"].flatten(1).any(1))[0])
    spare = int(engine.alloc.alloc(1)[0])
    stream = engine.stream("read")
    stream.memcopy([(BlockRef("k", src), BlockRef("k", spare))])
    got = stream.flush().block_state(BlockRef("k", spare))
    assert got.dtype == np.float32 and got.any()
    np.testing.assert_array_equal(got, engine.pools["k"][src].float().numpy())


def _serve_key(line: str) -> str:
    """A serve_cow line without what may differ: the rate line's timing
    and device, a continuation's token ids."""
    if line.startswith("[serve] generated "):
        return line.split(" in ")[0]
    if line.startswith("  seq "):
        return line.split(":")[0]
    return line


def test_serve_cow_prints_the_reference_bookkeeping(capsys):
    ref = _reference("serve_cow.py", SERVE_ARGS)
    run, lines = _port("serve_cow", SERVE_ARGS, capsys)
    assert [_serve_key(x) for x in lines] == [_serve_key(x) for x in ref]
    assert any(x.startswith("  seq ") for x in lines)
    assert "max 1 launch/round" in "\n".join(lines)
    assert run.max_launches <= 1 and run.rounds == 6
    assert run.tokens == 6 * len(run.engine.cache.seqs)


class _Picked(Exception):
    """Raised by the stand-in for ``init_params``: the entry chose its
    config and would now make weights on the device."""


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("entry", ["serve --smoke", "serve_cow"])
def test_smoke_entries_pick_the_reduced_config_whatever_the_device(
        entry, device, monkeypatch):
    """``python -m repro_torch.launch.serve --smoke`` and
    ``examples/torch_serve_cow.py`` serve the reduced config of their arch
    on the card as on the CPU, as the reference's CLI and example do: the
    config each hands ``init_params`` (stopped there, before any device is
    touched)."""
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    picked = []

    def stand_in(cfg, *args, **kw):
        picked.append((cfg, kw.get("device")))
        raise _Picked

    if entry == "serve_cow":
        mod = _example("serve_cow")
        monkeypatch.setattr(mod, "init_params", stand_in)
        with pytest.raises(_Picked):
            mod.main(["--device", device])
        want = get_config("yi-6b").reduced()
    else:
        monkeypatch.setattr(serve, "init_params", stand_in)
        monkeypatch.setattr(sys, "argv", ["serve", "--smoke", "--device",
                                          device])
        with pytest.raises(_Picked):
            serve.main()
        want = get_config("llama3.2-3b").reduced()
    assert picked == [(want, device)]
    assert want.dtype == "float32" and want.head_dim == 32


#: a decimal number in a printed line
_NUMBER = re.compile(r"-?\d+\.\d+(?:e[-+]\d+)?")


def _train_split(line: str):
    """(the line with its weight-dependent numbers blanked, those numbers
    as (value, printed quantum, rtol)): the loss (rtol ``LOSS_RTOL``) and
    grad norm (rtol 1e-3, the one-step tolerance of
    ``tests/test_torch_train_loop.py``) of a ``[train]`` line, the losses
    of the ``done`` line; the checkpoint directory blanked."""
    if line.startswith("[e2e] checkpoints -> "):
        return "[e2e] checkpoints -> <dir>", []
    if not line.startswith(("[train] step ", "[e2e] done: ")):
        return line, []
    # the learning rate is no weight's: it stays in the line
    lr = line.split(" lr ")[1].split()[0] if " lr " in line else None
    nums = []

    def blank(m):
        text = m.group(0)
        if text == lr:
            return text
        rtol = 1e-3 if " gnorm " in line and len(nums) == 1 else LOSS_RTOL
        nums.append((float(text), 10.0 ** -len(text.split(".")[1]), rtol))
        return "#"

    return _NUMBER.sub(blank, line), nums


def _reference_weights(cfg):
    """The reference's initial weights of ``cfg`` (its ``train_loop``'s,
    ``init_params(jax.random.key(0))``) as the port's fp32 model."""
    from repro.models import build_model, split_params
    from repro_torch.configs import get_config
    from repro_torch.weights import from_jax_params
    jmodel = build_model(cfg)
    params, _ = split_params(jmodel.init_params(jax.random.key(0)))
    tree = jax.tree_util.tree_map(np.asarray, params)
    return from_jax_params(tree, get_config("llama-100m"), "cpu",
                           param_dtype=torch.float32)


def test_train_e2e_matches_the_reference(capsys):
    ref = _reference("train_e2e.py", TRAIN_ARGS)
    # the reference's own config, registered by its example, and loop
    _module(EXAMPLES / "train_e2e.py", "train_e2e_reference").register_100m()
    from repro.configs import get_config as jget_config
    from repro.launch.train import train_loop as jtrain_loop
    with tempfile.TemporaryDirectory() as d:
        _, jlosses = jtrain_loop("llama-100m", steps=3, batch=1, seq_len=32,
                                 smoke=False, ckpt_dir=d, checkpoint_every=50,
                                 log_every=10, learning_rate=1e-3)
    from repro_torch.configs import _REGISTRY
    _REGISTRY.pop("llama-100m", None)
    port = _example("train_e2e")
    capsys.readouterr()
    port.register_100m()
    model = _reference_weights(jget_config("llama-100m"))
    with tempfile.TemporaryDirectory() as d:
        run = port.train_e2e(3, 1, 32, fail_at=2, device="cpu", model=model,
                             ckpt_dir=d)
    lines = [x for x in capsys.readouterr().out.splitlines()
             if not x.startswith("[e2e] timing on ")]
    assert run.restarted and len(run.losses) == 3
    np.testing.assert_allclose(run.losses, jlosses, rtol=LOSS_RTOL)
    assert lines[0] == ref[0] == "[e2e] registered llama-100m: 55.9M params"
    assert len(lines) == len(ref)
    for mine, theirs in zip(lines, ref):
        m_line, m_nums = _train_split(mine)
        r_line, r_nums = _train_split(theirs)
        assert m_line == r_line
        assert len(m_nums) == len(r_nums)
        for (a, quantum, rtol), (b, _, _) in zip(m_nums, r_nums):
            # each side rounds once to the printed digits
            assert abs(a - b) <= rtol * abs(b) + quantum, (mine, theirs)


def test_train_e2e_restart_without_checkpoint_starts_from_initial_weights(
        capsys):
    """A failure before the first checkpoint restarts from the initial
    weights: the restarted run's losses equal those of a run that never
    failed, from the same model, although the failed call trained that
    model in place."""
    from repro_torch.weights import init_params
    port = _example("train_e2e")
    port.register_100m()
    from repro_torch.configs import get_config
    cfg = get_config("llama-100m")
    model = init_params(cfg, seed=3, device="cpu", param_dtype=torch.float32)
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    with tempfile.TemporaryDirectory() as d:
        failed = port.train_e2e(3, 1, 32, fail_at=2, device="cpu",
                                model=model, ckpt_dir=d)
    assert failed.restarted
    assert any(not torch.equal(p, before[n])
               for n, p in model.named_parameters())
    clean = init_params(cfg, seed=3, device="cpu", param_dtype=torch.float32)
    with tempfile.TemporaryDirectory() as d:
        whole = port.train_e2e(3, 1, 32, fail_at=None, device="cpu",
                               model=clean, ckpt_dir=d)
    assert not whole.restarted
    assert failed.losses == whole.losses
    assert "[train] restored step" not in capsys.readouterr().out


def test_package_surfaces_cover_the_reference():
    """``repro_torch.core`` exports every name ``repro.core`` exports and
    ``repro_torch.models`` ``LanguageModel`` and ``build_model``; the
    three names it has no counterpart of are named in its docstring."""
    import repro.core as jcore
    import repro.models as jmodels
    import repro_torch.core as tcore
    import repro_torch.models as tmodels
    assert set(jcore.__all__) <= set(tcore.__all__)
    for name in jcore.__all__:
        mine, theirs = getattr(tcore, name), getattr(jcore, name)
        assert type(mine) is type(theirs) or (
            isinstance(mine, type) and isinstance(theirs, type)), name
        if isinstance(theirs, type) or callable(theirs):
            assert mine.__name__ == theirs.__name__, name
        else:
            # the registry's entries are each package's own OpSpec
            assert repr(mine) == repr(theirs), name
    assert {"LanguageModel", "build_model"} <= set(tmodels.__all__)
    missing = set(jmodels.__all__) - set(tmodels.__all__)
    assert missing == {"Param", "is_param", "split_params"}
    assert all(f"``{n}``" in tmodels.__doc__ for n in missing)
    model = tmodels.build_model(_small_config(), device="cpu")
    assert isinstance(model, tmodels.LanguageModel)
    assert all(not p.any() for p in model.parameters())


def _small_config():
    from repro_torch.configs import get_config
    return get_config("llama3.2-3b").reduced()


def test_kernel_module_imports_first_without_the_engine():
    """``import repro_torch.kernels.fused_dispatch`` as the first import of
    the port works and loads the opcode registry but not the engine (the
    core package resolves its names lazily); the names then resolve."""
    code = ("import sys\n"
            "import repro_torch.kernels.fused_dispatch\n"
            "print('ENGINE=' + str('repro_torch.core.rowclone' in "
            "sys.modules))\n"
            "print('OPCODES=' + str('repro_torch.core.opcodes' in "
            "sys.modules))\n"
            "from repro_torch.core import *\n"
            "from repro_torch.models import *\n"
            "print('ENGINE=' + str(RowCloneEngine.__module__))\n"
            "print('MODEL=' + str(build_model.__module__))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["ENGINE=False", "OPCODES=True",
                                  "ENGINE=repro_torch.core.rowclone",
                                  "MODEL=repro_torch.models.lm"]


def test_restart_finds_the_checkpoint_saved_just_before_the_failure(
        tmp_path, monkeypatch):
    """A failure at the step right after a checkpoint: ``train_loop``
    lets the checkpoint's background write land before the failure
    propagates, so the restart restores it (the example's failure at step
    steps // 2 follows its checkpoint at once).  The writes are slowed, so
    a restart that did not wait would find no checkpoint."""
    import threading
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.launch.train import train_loop
    from repro_torch.runtime import NodeFailure
    write = CheckpointManager._write
    started = threading.Event()

    def slow_write(self, step, flat):
        started.set()
        threading.Event().wait(0.5)
        write(self, step, flat)

    monkeypatch.setattr(CheckpointManager, "_write", slow_write)
    loop = dict(steps=6, batch=2, seq_len=32, log_every=100, device="cpu",
                ckpt_dir=str(tmp_path), checkpoint_every=3)
    with pytest.raises(NodeFailure):
        train_loop("llama3.2-3b", inject_failure_at=3, **loop)
    assert started.is_set()
    assert CheckpointManager(str(tmp_path)).latest_step() == 3
    _, resumed = train_loop("llama3.2-3b", **loop)
    assert len(resumed) == 3
