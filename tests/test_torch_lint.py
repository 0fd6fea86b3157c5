"""The contract lint over the port (``src/repro_torch``), with the rule
functions of ``tools/rowlint.py`` and ``tools/check_docs.py`` (both
stdlib-only; neither tool walks the port on its own):

* RC101 against the port's own opcode registry (``core/opcodes.py``,
  loaded by file path), RC102, RC103 and RC105 over every module of the
  package, honouring line waivers, with the tool's homes matched by
  suffix (``core/poolspec.py``, ``core/rowclone.py``, ``/obs/``);
* RC104 on the port's ``core/rowclone.py`` and ``core/stream.py``, with
  :data:`PORT_MIRROR_PINS` as its pins;
* docstring coverage of ``repro_torch.core``, ``.kernels``,
  ``.models.paged``, ``.launch`` and ``.obs`` (``check_docs``'
  ``iter_modules`` / ``check_symbol``);
* every ``repro.*`` pin of ``check_docs.REQUIRED_SYMBOLS`` mapped to its
  port counterpart (:data:`PORT_PINS`), each resolved and documented;
* one seeded mutation per rule, in a scratch copy of the package, found.
"""
import ast
import importlib.util
import inspect
import pathlib
import shutil
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))     # the `tools` package

from tools import check_docs, rowlint  # noqa: E402

#: the port's packages whose public symbols need a docstring (the
#: reference's ``check_docs.PACKAGES``)
PORT_PACKAGES = ("repro_torch.core", "repro_torch.kernels",
                 "repro_torch.models.paged", "repro_torch.launch",
                 "repro_torch.obs")

#: the port's CommandStream mirror of each engine verb that enqueues
#: commands: RC104's pins
PORT_MIRROR_PINS = tuple(
    f"repro_torch.core.stream.CommandStream.{verb}"
    for verb in ("memcopy", "memcopy_cross", "meminit", "materialize_zeros",
                 "promote_staged", "demote_to_spill", "promote_spilled",
                 "memand", "memor", "memnot"))

#: the pins of ``check_docs.REQUIRED_SYMBOLS`` that sit at another path
#: in the port; every other ``repro.X`` pin is ``repro_torch.X``
MOVED_PINS = {
    # the pool's mesh layout lives with the mesh in the port
    "repro.models.paged.pool_partition_spec":
        "repro_torch.launch.mesh.pool_partition_spec",
    # the packed-source codec lives with the opcode registry that uses it
    "repro.kernels.fused_dispatch.pack_bitwise_src":
        "repro_torch.core.opcodes.pack_bitwise_src",
}
#: every ``repro.*`` pin with its port counterpart (none lacks one)
PORT_PINS = {pin: MOVED_PINS.get(pin, "repro_torch" + pin[len("repro"):])
             for pin in check_docs.REQUIRED_SYMBOLS
             if pin.startswith("repro.")}


def port_registry_constants(pkg: pathlib.Path) -> set:
    """The ``OP_*`` names of the port's opcode registry, loaded by file
    path as ``rowlint.load_registry_constants`` loads the reference's."""
    spec = importlib.util.spec_from_file_location(
        "_port_rowlint_opcodes", pkg / "core" / "opcodes.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    try:
        spec.loader.exec_module(mod)
    finally:
        sys.modules.pop(spec.name, None)
    return set(mod.CONSTANT_NAMES)


def lint_modules(root: pathlib.Path) -> list:
    """RC101, RC102, RC103 and RC105 over every module of
    ``<root>/src/repro_torch``; the un-waived violations."""
    pkg = root / "src" / "repro_torch"
    constants = port_registry_constants(pkg)
    found = []
    for path in sorted(pkg.rglob("*.py")):
        rel = str(path.relative_to(root))
        source = path.read_text()
        tree = ast.parse(source, filename=rel)
        waived = rowlint.line_waivers(source)
        found += [v for v in (rowlint.check_opcode_registry(tree, rel,
                                                            constants)
                              + rowlint.check_stacked_ids(tree, rel)
                              + rowlint.check_pool_mutation(tree, rel)
                              + rowlint.check_raw_clocks(tree, rel))
                  if v.rule not in waived.get(v.line, ())]
    return found


def verb_mirrors(root: pathlib.Path, scratch: pathlib.Path,
                 pins=PORT_MIRROR_PINS) -> list:
    """RC104 on ``<root>/src/repro_torch/core/{rowclone,stream}.py``:
    ``rowlint.check_verb_mirrors`` reads the engine and the stream at the
    reference's paths under a root, and its pins from that root's
    ``tools/check_docs.py``, so both modules are laid out there under
    ``scratch`` with ``pins`` as the reference's names."""
    core = scratch / "src" / "repro" / "core"
    core.mkdir(parents=True, exist_ok=True)
    for name in ("rowclone.py", "stream.py"):
        shutil.copy(root / "src" / "repro_torch" / "core" / name, core / name)
    (scratch / "tools").mkdir(exist_ok=True)
    renamed = tuple("repro" + p[len("repro_torch"):] for p in pins)
    (scratch / "tools" / "check_docs.py").write_text(
        f"REQUIRED_SYMBOLS = {renamed!r}\n")
    return rowlint.check_verb_mirrors(scratch)


def missing_docstrings(packages=PORT_PACKAGES) -> list:
    """The public symbols of ``packages`` without a docstring, by
    ``check_docs``' rule (modules, functions and classes defined there,
    and the public methods of those classes)."""
    missing = []
    for pkg in packages:
        for mod_name, mod in check_docs.iter_modules(pkg):
            if not (mod.__doc__ and mod.__doc__.strip()):
                missing.append(mod_name)
            for name, obj in vars(mod).items():
                if name.startswith("_") or not (
                        inspect.isfunction(obj) or inspect.isclass(obj)):
                    continue
                if getattr(obj, "__module__", None) != mod_name:
                    continue        # re-export; checked where defined
                check_docs.check_symbol(f"{mod_name}.{name}", obj, missing)
                if inspect.isclass(obj):
                    for mname, meth in vars(obj).items():
                        if mname.startswith("_") or \
                                mname in check_docs.SKIP_METHODS:
                            continue
                        target = _unwrap(meth)
                        if callable(target):
                            check_docs.check_symbol(
                                f"{mod_name}.{name}.{mname}", target,
                                missing)
    return sorted(missing)


def _unwrap(obj):
    if isinstance(obj, (staticmethod, classmethod)):
        return obj.__func__
    if isinstance(obj, property):
        return obj.fget
    return obj


# ---------------------------------------------------------------------------
# the real tree
# ---------------------------------------------------------------------------

def test_rules_clean_on_the_port():
    assert lint_modules(REPO) == []


def test_the_waived_clock_is_the_manifest_stamp():
    """The port's one waiver is the reference's: the checkpoint
    manifest's time-of-day stamp."""
    waived = []
    for path in sorted((REPO / "src" / "repro_torch").rglob("*.py")):
        for line, rules in rowlint.line_waivers(path.read_text()).items():
            waived += [(path.name, line, r) for r in rules]
    assert [(n, r) for n, _, r in waived] == [("manager.py", "RC105")]


def test_stream_mirrors_every_enqueueing_verb(tmp_path):
    assert verb_mirrors(REPO, tmp_path) == []
    for pin in PORT_MIRROR_PINS:
        assert check_docs.resolve(pin) is not None, pin


def test_docstring_coverage_of_the_port():
    assert missing_docstrings() == []


def test_required_symbols_have_port_counterparts():
    assert set(PORT_PINS) == {p for p in check_docs.REQUIRED_SYMBOLS
                              if p.startswith("repro.")}
    for pin, counterpart in PORT_PINS.items():
        obj = check_docs.resolve(counterpart)
        assert obj is not None, (pin, counterpart)
        missing = []
        check_docs.check_symbol(counterpart, _unwrap(obj), missing)
        assert missing == [], (pin, counterpart)
    for pin, moved in MOVED_PINS.items():
        assert check_docs.resolve("repro_torch" + pin[len("repro"):]) is None
        assert check_docs.resolve(moved) is not None


# ---------------------------------------------------------------------------
# seeded mutations, in a scratch copy of the package
# ---------------------------------------------------------------------------

def _copy_port(tmp_path: pathlib.Path) -> pathlib.Path:
    root = tmp_path / "mutant"
    shutil.copytree(REPO / "src" / "repro_torch",
                    root / "src" / "repro_torch",
                    ignore=shutil.ignore_patterns("__pycache__", "csrc"))
    return root


def _append(root: pathlib.Path, rel: str, text: str) -> None:
    path = root / "src" / "repro_torch" / rel
    path.write_text(path.read_text() + text)


MUTATIONS = {
    "RC101": ("core/cmdqueue.py", "\n_MUTANT = OP_STRIDED_COPY\n"),
    "RC102": ("core/journal.py", "\n\ndef _mutant_gid(pool, nblk, block):\n"
                                 "    return pool * nblk + block\n"),
    "RC103": ("core/journal.py", "\n\ndef _mutant_write(engine, name, t):\n"
                                 "    engine.pools[name] = t\n"),
    "RC105": ("launch/serve.py", "\n\ndef _mutant_clock():\n"
                                 "    import time\n"
                                 "    return time.perf_counter()\n"),
}


@pytest.mark.parametrize("rule", sorted(MUTATIONS))
def test_seeded_mutation_is_found(rule, tmp_path):
    root = _copy_port(tmp_path)
    assert lint_modules(root) == []
    rel, text = MUTATIONS[rule]
    _append(root, rel, text)
    found = lint_modules(root)
    assert {v.rule for v in found} == {rule}
    assert all(v.path.endswith(rel) for v in found)


@pytest.mark.parametrize("rel", ["core/poolspec.py", "obs/metrics.py"])
def test_seeded_mutation_legal_in_its_home(rel, tmp_path):
    """Stacked-id arithmetic in the codec module and a raw clock in the
    obs package are their rules' homes."""
    root = _copy_port(tmp_path)
    rule = "RC102" if rel == "core/poolspec.py" else "RC105"
    _append(root, rel, MUTATIONS[rule][1])
    assert lint_modules(root) == []


def test_seeded_verb_without_mirror_is_found(tmp_path):
    root = _copy_port(tmp_path)
    mod = root / "src" / "repro_torch" / "core" / "rowclone.py"
    src = mod.read_text()
    verb = ('    def memswap(self, pairs):\n'
            '        """Mutant verb: enqueues with no stream mirror."""\n'
            '        for s, d in pairs:\n'
            '            self._queues["default"].enqueue(0, s, d)\n'
            '\n'
            '    def memand(')
    assert "    def memand(" in src
    mod.write_text(src.replace("    def memand(", verb, 1))
    found = verb_mirrors(root, tmp_path / "rc104")
    assert {v.rule for v in found} == {"RC104"}
    assert all("memswap" in v.message for v in found)
    # a dropped pin is found too
    found = verb_mirrors(REPO, tmp_path / "pins", PORT_MIRROR_PINS[1:])
    assert [v.rule for v in found] == ["RC104"]
    assert "memcopy" in found[0].message


def test_seeded_undocumented_function_is_found(tmp_path):
    """A public function without a docstring in a scratch copy of the
    port is reported (the coverage runs in a fresh interpreter on the
    copy)."""
    root = _copy_port(tmp_path)
    _append(root, "core/cmdqueue.py", "\n\ndef mutant_verb():\n"
                                      "    return 0\n")
    code = ("import test_torch_lint as t\n"
            "print('MISSING=' + ','.join(t.missing_docstrings()))\n")
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True,
        cwd=tmp_path, timeout=300,
        env={"PYTHONPATH": f"{root / 'src'}:{REPO / 'tests'}:{REPO}",
             "PATH": "/usr/bin:/bin"})
    assert out.returncode == 0, out.stderr
    missing = out.stdout.split("MISSING=")[1].split()[0]
    assert missing == "repro_torch.core.cmdqueue.mutant_verb"
