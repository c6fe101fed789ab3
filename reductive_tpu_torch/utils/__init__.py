"""Utilities: profiling and timing helpers, and the package's spans."""

from .profiling import benchmark, device_sync, recorded_spans, span, trace

__all__ = ["trace", "device_sync", "benchmark", "span", "recorded_spans"]
