"""Attribute-access dict used for all config plumbing, copied from
``inclusivegan_tpu/utils/easydict.py``: a plain ``dict`` whose items are also
reachable as attributes, so configs compose as nested literals and pickle
cleanly.
"""

from typing import Any


class EasyDict(dict):
    """dict with attribute access; missing attribute raises AttributeError."""

    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError:
            raise AttributeError(name) from None

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError:
            raise AttributeError(name) from None

    def copy(self) -> "EasyDict":
        return EasyDict(self)


def pretty(d: dict, indent: int = 0) -> str:
    """Render a (possibly nested) config dict as indented text, one key per
    line — used for the human-readable ``submit_config.txt`` artifact
    (reference: submit.py:229-231)."""
    lines = []
    pad = " " * indent
    for k in sorted(d.keys(), key=str):
        v = d[k]
        if isinstance(v, dict) and v:
            lines.append(f"{pad}{k}:")
            lines.append(pretty(v, indent + 2))
        else:
            lines.append(f"{pad}{k}: {v!r}")
    return "\n".join(lines)
