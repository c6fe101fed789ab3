"""Utilities: profiling and timing helpers, and the package's spans and counters."""

from .profiling import benchmark, count, device_sync, recorded_spans, span, trace

__all__ = ["trace", "device_sync", "benchmark", "span", "count", "recorded_spans"]
