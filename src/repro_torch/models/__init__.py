"""The port's models: ``lm`` (:class:`LanguageModel`, every family),
``transformer``, ``attention``, ``moe``, ``mamba2``, ``common`` and
``paged``.  The package exports ``LanguageModel`` and ``build_model``, as
``repro.models`` does.

``repro.models`` also exports ``Param``, ``is_param`` and
``split_params``: a JAX parameter tree holds ``Param`` leaves (a value
and its logical axes), and ``split_params`` splits it into a value tree
and an axes tree.  The port has no such tree and so no counterpart of
the three: its weights are the ``torch.nn.Parameter`` attributes of the
model (``model.named_parameters()``), filled by
``repro_torch.weights.init_params`` or ``from_jax_params``, and their
logical axes come from ``repro_torch.weights.params_axes(model)``.

The names resolve at first use (the module ``__getattr__``, PEP 562):
``kernels/ref.py`` imports ``models.mamba2``, and ``models.lm`` imports
the kernels, so an eager import of ``lm`` here would close that cycle."""
from importlib import import_module

#: the submodule that defines each exported name
_LAZY = {"LanguageModel": "lm", "build_model": "lm"}


def __getattr__(name: str):
    """Resolve an exported name from its submodule at first use."""
    if name not in _LAZY:
        raise AttributeError(f"module {__name__!r} has no attribute "
                             f"{name!r}")
    value = getattr(import_module(f"{__name__}.{_LAZY[name]}"), name)
    globals()[name] = value
    return value


def __dir__():
    """The module's names, the lazily resolved ones included."""
    return sorted(set(globals()) | set(_LAZY))


__all__ = list(_LAZY)
