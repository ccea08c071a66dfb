"""Phase timing, device traces and raster rendering (copies of
pcr_tpu/utils, with a torch.profiler trace)."""

from .profiling import PhaseTimer, trace  # noqa: F401
from . import visualization  # noqa: F401
