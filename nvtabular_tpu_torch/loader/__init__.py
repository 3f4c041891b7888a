"""Training feed (counterpart of nvtabular_tpu/loader/): the device loader.

The host ``Loader`` and the framework adapters are not ported yet
(ROADMAP.md queue 1 item 8).
"""

from ..unported import stubs
from .device_loader import DeviceLoader

__all__ = ["DeviceLoader"]
__getattr__ = stubs(__name__, {"Loader": 8, "augment_schema": 8})
