"""What is particular to a model family, found by the name that its
configuration file gives under ``family``: two files laid out by that name,
as a metric's reader is found by the metric's.

* ``portbench/families/<family>.py``, the program's side: ``model_config``,
  ``preset_config`` and ``build_model`` (the program's model of the
  configuration's widths), ``SCOPES`` (the program's module class names,
  each with the traced run's label of its layer), ``ATTENTION_MODULES``
  (the program modules whose ``attention`` the traced run wraps),
  ``forward_flops`` (a forward pass's FLOPs by part, ``attention`` among
  them) and ``bounds`` (the least seconds a batch of each bounded part). It
  imports the program only inside the functions that build it.
* ``portbench/reference/<family>.py``, the plain reference: ``param_specs``,
  ``forward``, ``ctc_losses``, ``Precision`` and, for weight kinds that
  :func:`portbench.inputs.weights` does not draw itself, ``KINDS``. It
  imports nothing of the program.

A new family is these two files and a configuration that names it; no
other file of the harness changes.
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def _load(package: str, name: str):
    """``portbench/<package>/<name>.py`` as the module
    ``portbench.<package>.<name>``, loaded once: by its file, since a
    family's name may hold ``-`` or ``.``."""
    full = f"portbench.{package}.{name}"
    module = sys.modules.get(full)
    if module is None:
        path = HERE / package / f"{name}.py"
        if not path.is_file():
            raise FileNotFoundError(f"family {name!r} has no {path.relative_to(HERE.parent)}")
        spec = importlib.util.spec_from_file_location(full, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[full] = module
        try:
            spec.loader.exec_module(module)
        except BaseException:
            del sys.modules[full]
            raise
    return module


def program(cfg: dict):
    """The program's side of ``cfg``'s family: ``families/<family>.py``."""
    return _load("families", cfg["family"])


def reference(cfg: dict):
    """The plain reference of ``cfg``'s family: ``reference/<family>.py``."""
    return _load("reference", cfg["family"])
