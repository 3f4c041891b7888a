"""Public names of the reference that the port does not have yet.

``stubs(module, {name: item})`` gives a module ``__getattr__`` under which
each listed name raises ``NotImplementedError`` naming its ROADMAP.md item,
and any other missing name raises ``AttributeError`` as usual.
"""

from __future__ import annotations

from typing import Callable, Dict

ITEMS = {
    2: "save/load and the Workflow facade",
    4: "strings, wide keys and the hybrid frontier",
    8: "the rest of the loader",
    11: "the hetero executor and its host engine",
    15: "tools, bridges and host helpers",
    16: "parquet beyond the native subset",
}


def message(what: str, item: int) -> str:
    return f"{what} is not ported yet (ROADMAP.md queue 1 item {item}: {ITEMS[item]})"


def stubs(module: str, names: Dict[str, int]) -> Callable[[str], object]:
    def __getattr__(name: str):
        if name in names:
            raise NotImplementedError(message(f"{module}.{name}", names[name]))
        raise AttributeError(f"module {module!r} has no attribute {name!r}")

    return __getattr__
