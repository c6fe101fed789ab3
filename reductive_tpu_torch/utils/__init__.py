"""Utilities: profiling and timing helpers."""

from .profiling import benchmark, device_sync, trace

__all__ = ["trace", "device_sync", "benchmark"]
