"""Host-side helpers: device-to-host transfers, the native host library,
timing and profiling, and the package's logger."""

from .profiling import Timer, time_execution
from .logging import get_logger

__all__ = ["Timer", "time_execution", "get_logger"]
