from .config import PRESETS, DroidConfig, preset
from .droid import Droid

__all__ = ["Droid", "DroidConfig", "PRESETS", "preset"]
