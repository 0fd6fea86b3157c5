"""The PyTorch port stands alone: it imports neither JAX nor anything of the
JAX package ``repro`` (not even its JAX-free modules), and neither do the
card scripts (``chip_smoke.py``, ``chip_ab.py``, ``chip_k4_logits.py``) nor
the card tests (``tests/test_torch_card.py``), which run where JAX is not
installed.  A
CUDA kernel wrapper refuses
CPU tensors instead of quietly running something else."""
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"

#: an import of jax or of the reference package; ``repro_torch`` does not
#: match (``repro`` must end the module name or be followed by a dot)
FORBIDDEN = re.compile(
    r"^\s*(import\s+jax\b|from\s+jax\b|import\s+repro(\.|\s|,|$)"
    r"|from\s+repro(\.|\s))", re.M)


#: modules of the per-mechanism, the Mamba2, the moe, the serving
#: features, the traffic, the recovery, the observability, the mesh, the
#: training and the sharding-rules slices; the scans below must reach them
NEW_MODULES = ("repro_torch.kernels.fpm_copy", "repro_torch.kernels.zero_init",
               "repro_torch.core.migration", "repro_torch.launch.mechanisms",
               "repro_torch.launch.applications",
               "repro_torch.kernels.ssd_chunk", "repro_torch.models.mamba2",
               "repro_torch.models.moe", "repro_torch.obs.metrics",
               "repro_torch.launch.scheduler",
               "repro_torch.launch.multitenant",
               "repro_torch.runtime.fault",
               "repro_torch.checkpoint.manager",
               "repro_torch.checkpoint.pool_checkpoint",
               "repro_torch.core.sanitizer", "repro_torch.obs.trace",
               "repro_torch.obs.autotune", "repro_torch.launch.autotune",
               "repro_torch.launch.mesh", "repro_torch.kernels.psm_transfer",
               "repro_torch.data.pipeline", "repro_torch.optim.adamw",
               "repro_torch.optim.compress", "repro_torch.launch.train",
               "repro_torch.sharding.rules", "repro_torch.runtime.elastic")


def _modules():
    import repro_torch
    names = ["repro_torch"]
    for info in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
        names.append(info.name)
    return names


def test_import_everything_loads_no_jax_or_reference():
    """Import the package and every submodule, each as the first import of
    the port, in a fresh interpreter: every import succeeds, and no
    ``jax*`` module and no ``repro`` / ``repro.*`` module loads."""
    names = _modules()
    assert set(NEW_MODULES) < set(names) and len(names) > 20
    # each module is imported FIRST once (the port's own modules are
    # dropped before each import), so no import order hides a cycle
    code = ("import importlib, sys\n"
            f"for n in {names!r}:\n"
            "    for m in [m for m in sys.modules "
            "if m.startswith('repro_torch')]:\n"
            "        del sys.modules[m]\n"
            "    importlib.import_module(n)\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m.startswith('jaxlib') or "
            "m == 'repro' or m.startswith('repro.'))\n"
            "print('BAD=' + ','.join(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300,
                         env={"PYTHONPATH": str(ROOT / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    assert "BAD=\n" in out.stdout, out.stdout


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(ROOT)) for p in list(PKG.rglob("*.py"))
    + [ROOT / "chip_smoke.py", ROOT / "chip_ab.py",
       ROOT / "chip_k4_logits.py", ROOT / "tests" / "test_torch_card.py"]))
def test_source_has_no_forbidden_import(path):
    """No source file of the port, none of the card scripts
    (chip_smoke.py, chip_ab.py, chip_k4_logits.py) and not the card tests
    (tests/test_torch_card.py) names jax or the reference package in an
    import statement."""
    text = (ROOT / path).read_text()
    hits = FORBIDDEN.findall(text)
    assert not hits, f"{path}: {hits}"


def test_card_tests_import_without_jax():
    """tests/test_torch_card.py imports in an interpreter where ``jax`` and
    ``repro`` cannot be imported, and holds every ``cuda``-marked test of
    the port (the card's machine has no JAX)."""
    code = ("import sys\n"
            "for m in ('jax', 'jaxlib', 'repro'):\n"
            "    sys.modules[m] = None\n"
            "import test_torch_card as t\n"
            "print('CUDA=' + ','.join(sorted(n for n, f in vars(t).items() "
            "if n.startswith('test_') and any(m.name == 'cuda' for m in "
            "getattr(f, 'pytestmark', ())))))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300,
                         env={"PYTHONPATH": f"{ROOT / 'tests'}:{ROOT / 'src'}",
                              "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    marked = out.stdout.split("CUDA=")[1].split()[0].split(",")
    assert len(marked) == 27, marked
    marker = "@pytest.mark." + "cuda"
    others = [p for p in (ROOT / "tests").glob("test_torch_*.py")
              if p.name != "test_torch_card.py" and marker in p.read_text()]
    assert not others, others


def test_pattern_tells_the_port_from_the_reference():
    assert FORBIDDEN.search("import jax.numpy as jnp")
    assert FORBIDDEN.search("from repro.core import X")
    assert FORBIDDEN.search("import repro")
    assert FORBIDDEN.search("from repro import configs")
    assert not FORBIDDEN.search("import repro_torch")
    assert not FORBIDDEN.search("from repro_torch.core import X")


def test_kernel_request_on_cpu_tensor_raises():
    """use_kernel=True on a CPU tensor raises: the plain version runs only
    for CPU tensors or under an explicit plain override."""
    from repro_torch.kernels import ops
    q = torch.zeros((1, 2, 4, 128))
    with pytest.raises(ValueError):
        ops.flash_attention(q, q, q, use_kernel=True)
    dt = torch.zeros((1, 2, 4))
    for call in (lambda: ops.fpm_copy(q, [[0, 1]], use_kernel=True),
                 lambda: ops.fpm_copy_cross(q, q, [[0, 1]], use_kernel=True),
                 lambda: ops.meminit_zero(q, [0], use_kernel=True),
                 lambda: ops.psm_copy(q, [[0, 1]], use_kernel=True),
                 lambda: ops.psm_transfer([q[0], q[0]], [[[0, 1, 1]],
                                                         [[-1, 0, 0]]],
                                          use_kernel=True),
                 lambda: ops.ssd_intra_chunk(q, dt, dt, q[0], q[0],
                                             use_kernel=True)):
        with pytest.raises(ValueError):
            call()
    assert not ops.use_kernel_for(q, None)
    with ops.plain_versions():
        assert not ops.use_kernel_for(q, None)


def test_entry_points_default_to_the_card():
    """Without a GPU an entry point that was not asked for the CPU raises
    rather than silently running there."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid")
    from repro_torch.configs import get_config
    from repro_torch.launch import applications, mechanisms
    from repro_torch.weights import init_params
    cfg = get_config("llama3.2-3b").reduced()
    with pytest.raises(RuntimeError):
        init_params(cfg, seed=0)
    with pytest.raises(RuntimeError):
        mechanisms.run()
    with pytest.raises(RuntimeError):
        applications.run(cfg)
    from repro_torch.launch.train import train_loop
    with pytest.raises(RuntimeError):
        train_loop("llama3.2-3b", steps=1)


@pytest.mark.parametrize("module", NEW_MODULES)
def test_new_module_scanned_and_jax_free(module):
    """Each module of the per-mechanism slice is on the import scan's list
    and names neither jax nor the reference package."""
    assert module in _modules()
    path = PKG.joinpath(*module.split(".")[1:]).with_suffix(".py")
    assert not FORBIDDEN.findall(path.read_text())


@pytest.mark.parametrize("wrapper", ["fpm_copy", "fpm_copy_cross",
                                     "zero_init", "ssd_intra_chunk"])
def test_cuda_wrapper_refuses_cpu_tensors(wrapper):
    """The CUDA wrappers themselves refuse CPU tensors (no CPU path hides
    behind them)."""
    from repro_torch.kernels import fpm_copy, ssd_chunk, zero_init
    pool = torch.zeros((8, 16))
    x, dt, bc = (torch.zeros((1, 8, 2, 64)), torch.zeros((1, 8, 2)),
                 torch.zeros((1, 8, 16)))
    call = {"fpm_copy": lambda: fpm_copy.fpm_copy_cuda(
                pool, [[0, 1]], block_axis=0),
            "fpm_copy_cross": lambda: fpm_copy.fpm_copy_cross_cuda(
                pool, pool, [[0, 1]], block_axis=0),
            "zero_init": lambda: zero_init.zero_init_cuda(
                pool, [1], block_axis=0),
            "ssd_intra_chunk": lambda: ssd_chunk.ssd_intra_chunk_cuda(
                x, dt, dt, bc, bc)}[wrapper]
    with pytest.raises(ValueError):
        call()


def test_chip_smoke_refuses_without_gpu():
    """chip_smoke.py exits non-zero and prints nothing on stdout when no
    GPU is visible."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         capture_output=True, text=True, cwd=ROOT,
                         timeout=300)
    assert out.returncode != 0
    assert out.stdout == ""
