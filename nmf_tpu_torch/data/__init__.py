"""Dataset loading (numpy, host side): ``load_dataset`` of ``blender.py``,
the port's counterpart of ``nmf_tpu/data/blender.py:load_dataset``."""
from .blender import load_dataset

__all__ = ["load_dataset"]
