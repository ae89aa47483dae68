"""``print_layers`` / ``count_params`` over a module's ``named_parameters()``,
after ``inclusivegan_tpu/utils/network_util.py``: one row per layer (the
parameters that share a name up to their last dot), with its parameter
count and shapes. Conv weights show in the port's OIHW layout."""

from typing import List, Tuple

from torch import nn


def list_layers(module: nn.Module) -> List[Tuple[str, int, list]]:
    """[(layer name, number of parameters, [shapes, ...])], in the order the
    module registered them."""
    rows = {}
    for name, p in module.named_parameters():
        layer = name.rsplit(".", 1)[0] if "." in name else "<root>"
        n, shapes = rows.get(layer, (0, []))
        rows[layer] = (n + p.numel(), shapes + [list(p.shape)])
    return [(layer, n, shapes) for layer, (n, shapes) in rows.items()]


def count_params(module: nn.Module) -> int:
    return sum(p.numel() for p in module.parameters())


def print_layers(module: nn.Module, title: str = "Network") -> int:
    rows = list_layers(module)
    total = count_params(module)
    name_w = max([len(r[0]) for r in rows] + [len(title)]) + 2
    print(f"\n{title:<{name_w}s}{'Params':<10s}Shapes")
    print("-" * (name_w + 40))
    for name, n, shapes in rows:
        print(f"{name:<{name_w}s}{n:<10d}{shapes}")
    print("-" * (name_w + 40))
    print(f"{'Total':<{name_w}s}{total:<10d}\n")
    return total
