"""The host serving engine (counterpart of nvtabular_tpu/serving/): not
ported yet; each of the reference's names raises naming its ROADMAP item."""

from ..unported import stubs

__getattr__ = stubs(__name__, {"CategorifyTransform": 11, "FillTransform": 11, "native_available": 11})
