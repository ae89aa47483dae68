"""Dotted-name -> object resolution, copied from
``inclusivegan_tpu/utils/registry.py``.

The run harness resolves its run function from a dotted name
(``inclusivegan_torch.training.training_loop.training_loop``), and
``data.dataset.load_dataset`` its dataset class: try progressively shorter
module prefixes, import, getattr the rest.
"""

import importlib
import types
from typing import Any, Tuple


def get_module_from_obj_name(obj_name: str) -> Tuple[types.ModuleType, str]:
    """Split 'pkg.mod.attr.subattr' into (imported module, 'attr.subattr')."""
    parts = obj_name.split(".")
    # Longest importable prefix wins.
    for split in range(len(parts), 0, -1):
        module_name = ".".join(parts[:split])
        try:
            module = importlib.import_module(module_name)
            return module, ".".join(parts[split:])
        except ImportError:
            continue
    raise ImportError(f"cannot import any prefix of: {obj_name!r}")


def get_obj_from_module(module: types.ModuleType, obj_name: str) -> Any:
    obj = module
    if obj_name:
        for part in obj_name.split("."):
            obj = getattr(obj, part)
    return obj


def get_obj_by_name(name: str) -> Any:
    module, rest = get_module_from_obj_name(name)
    return get_obj_from_module(module, rest)
