"""Observability: execution tracing and telemetry rendering.

``repro_torch.obs`` is a leaf package: it imports only
``repro_torch.core.envcfg`` so the engine can emit spans without import
cycles.  The span taxonomy is the reference package's
(``docs/observability.md``).
"""

from .trace import (TraceRecorder, configure_from_env, dump, enable,
                    instant, span_stats, stop, to_chrome, trace_begin,
                    trace_span, tracer)
from .pretty import format_stats, print_stats

__all__ = [
    "TraceRecorder", "tracer", "enable", "stop", "configure_from_env",
    "trace_span", "trace_begin", "instant", "to_chrome", "dump",
    "span_stats", "format_stats", "print_stats",
]
