"""Lazy re-exports for the port's subpackages (PEP 562).

Each subpackage's ``__init__`` names its public objects the way the JAX
package's does (``from deeprest_tpu_torch.serve import Predictor``), but
loads the module that defines one only when the name is first read: an
import of ``deeprest_tpu_torch.analysis`` (or of any one module) loads no
more than it did before, and no import cycle can appear through a package
``__init__``.
"""

from __future__ import annotations

import importlib
from typing import Callable, Mapping


def lazy_exports(package: str, exports: Mapping[str, str]
                 ) -> tuple[Callable[[str], object], Callable[[], list]]:
    """``(__getattr__, __dir__)`` for ``package``: ``exports`` maps each
    public name to the submodule (relative to ``package``) that defines
    it."""
    namespace = importlib.import_module(package).__dict__

    def __getattr__(name: str):
        module = exports.get(name)
        if module is None:
            raise AttributeError(
                f"module {package!r} has no attribute {name!r}")
        value = getattr(importlib.import_module(f"{package}.{module}"), name)
        namespace[name] = value
        return value

    def __dir__() -> list:
        return sorted(set(namespace) | set(exports))

    return __getattr__, __dir__
