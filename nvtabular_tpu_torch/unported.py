"""Public names of the reference that the port does not have yet.

``stubs(module, {name: item})`` gives a module ``__getattr__`` under which
each listed name raises ``NotImplementedError`` naming its ROADMAP.md item,
and any other missing name raises ``AttributeError`` as usual.
"""

from __future__ import annotations

from typing import Callable, Dict

ITEMS = {
    1: "parquet I/O",
    2: "save/load and the Workflow facade",
    8: "the rest of the loader",
    9: "the rest of the models",
    11: "the hetero executor and its host engine",
    15: "tools, bridges and host helpers",
}


def message(what: str, item: int) -> str:
    return f"{what} is not ported yet (ROADMAP.md queue 1 item {item}: {ITEMS[item]})"


def stubs(module: str, names: Dict[str, int]) -> Callable[[str], object]:
    def __getattr__(name: str):
        if name in names:
            raise NotImplementedError(message(f"{module}.{name}", names[name]))
        raise AttributeError(f"module {module!r} has no attribute {name!r}")

    return __getattr__
