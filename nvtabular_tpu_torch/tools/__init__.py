"""Data generation and inspection tools (counterpart of nvtabular_tpu/tools/):
not ported yet; each of the reference's names raises naming its ROADMAP item."""

from ..unported import stubs

__getattr__ = stubs(__name__, {name: 15 for name in (
    "CatCol", "Col", "ContCol", "DatasetGen", "DatasetInspector", "LabelCol", "PowerLawDistro", "UniformDistro",
    "cols_from_schema",
)})
