"""End-to-end training of the port on the CPU: the reference's
``tests/test_system.py`` tests and its restart test
(``tests/test_runtime.py::test_train_restart_reproduces_loss_trajectory``)
run on the port's ``train_loop``, with the reference's tolerances, and
Fig. 2's ``checkpoint`` application against the reference's rows."""
import numpy as np
import pytest

from test_torch_apps import load_benchmark
from test_torch_contract import one_thread  # noqa: F401 (the fixture)

from repro_torch.checkpoint import CheckpointManager
from repro_torch.launch import applications
from repro_torch.launch.train import train_loop
from repro_torch.runtime import NodeFailure

pytestmark = pytest.mark.usefixtures("one_thread")

CPU = dict(device="cpu", log_every=100)


def test_training_reduces_loss():
    """A tiny dense model learns the pipeline's affine-successor stream."""
    _, losses = train_loop("llama3.2-3b", steps=30, batch=4, seq_len=128,
                           smoke=True, learning_rate=3e-3, **CPU)
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    assert last < first - 0.2, (first, last)
    assert np.isfinite(losses).all()


def test_training_microbatch_equivalence():
    """microbatches=2 tracks microbatches=1 on the same global batch."""
    _, l1 = train_loop("yi-6b", steps=8, batch=4, seq_len=64, smoke=True,
                       microbatches=1, **CPU)
    _, l2 = train_loop("yi-6b", steps=8, batch=4, seq_len=64, smoke=True,
                       microbatches=2, **CPU)
    np.testing.assert_allclose(l1, l2, rtol=2e-2)


def test_ssm_training_runs():
    _, losses = train_loop("mamba2-780m", steps=10, batch=2, seq_len=128,
                           smoke=True, **CPU)
    assert np.isfinite(losses).all()


def test_moe_training_runs_and_balances():
    _, losses = train_loop("deepseek-moe-16b", steps=10, batch=2,
                           seq_len=64, smoke=True, **CPU)
    assert np.isfinite(losses).all()


def test_train_restart_reproduces_loss_trajectory(tmp_path):
    """Crash at step 15, restart from checkpoint 10: steps 10-19 repeat
    the uninterrupted run's losses (rtol 1e-5, the reference's; the CPU
    run is deterministic, so they are equal)."""
    arch = "llama3.2-3b"
    _, ref_losses = train_loop(arch, steps=20, batch=2, seq_len=64,
                               smoke=True, ckpt_dir=None, **CPU)
    ckpt_dir = str(tmp_path / "ckpt")
    with pytest.raises(NodeFailure):
        train_loop(arch, steps=20, batch=2, seq_len=64, smoke=True,
                   ckpt_dir=ckpt_dir, inject_failure_at=15,
                   checkpoint_every=10, **CPU)
    assert CheckpointManager(ckpt_dir).latest_step() == 10
    _, resumed = train_loop(arch, steps=20, batch=2, seq_len=64, smoke=True,
                            ckpt_dir=ckpt_dir, checkpoint_every=10, **CPU)
    assert len(resumed) == 10
    np.testing.assert_allclose(resumed, ref_losses[10:], rtol=1e-5)


def test_fig2_checkpoint_rows_match_reference():
    """The ``checkpoint`` application's rows carry the reference's fields
    and values (wall clocks not compared), blocking off and async on."""
    bench = load_benchmark("fig2_applications")
    want = {"off": bench._checkpoint_blocking(), "on": bench._checkpoint(True)}
    fn = dict(applications.APPS)["checkpoint"]
    for mode, on in (("off", False), ("on", True)):
        got = fn(None, None, on, applications.resolve_device("cpu"))
        assert got.pop("wall_s") > 0 and want[mode].pop("wall_s") > 0
        assert got == want[mode], mode
