"""Shared pretty-printer for server stats dicts.

``CamSearchServer.snapshot()`` and ``health()`` return nested dicts;
dumping them as raw JSON buries the numbers people actually look at
(latency windows, counters) under quoting noise.  :func:`format_stats`
renders the same structure as an aligned, indented key tree with floats
rounded to a sane width, so example output and ``snapshot()`` keys stay
in lockstep — there is exactly one renderer to update when telemetry
grows a field.
"""

from __future__ import annotations

from typing import Any, List

__all__ = ["format_stats", "print_stats"]


def _fmt_scalar(v: Any) -> str:
    if isinstance(v, bool) or v is None:
        return str(v)
    if isinstance(v, float):
        if v != v:                      # NaN
            return "nan"
        if v == 0 or 0.001 <= abs(v) < 1e7:
            return f"{v:.3f}".rstrip("0").rstrip(".")
        return f"{v:.3e}"
    return str(v)


def _render(obj: Any, indent: int, lines: List[str]) -> None:
    pad = "  " * indent
    if isinstance(obj, dict):
        width = max((len(str(k)) for k in obj), default=0)
        for k, v in obj.items():
            if isinstance(v, dict) and v:
                lines.append(f"{pad}{k}:")
                _render(v, indent + 1, lines)
            elif isinstance(v, (list, tuple)) and v and all(
                    isinstance(x, dict) for x in v):
                lines.append(f"{pad}{k}:")
                for i, x in enumerate(v):
                    lines.append(f"{pad}  [{i}]")
                    _render(x, indent + 2, lines)
            else:
                if isinstance(v, (list, tuple)):
                    body = "[" + ", ".join(_fmt_scalar(x) for x in v) + "]"
                else:
                    body = _fmt_scalar(v)
                lines.append(f"{pad}{str(k):<{width}}  {body}")
    else:
        lines.append(f"{pad}{_fmt_scalar(obj)}")


def format_stats(stats: Any, title: str = "") -> str:
    """Render a (nested) stats dict as an aligned key tree."""
    lines: List[str] = []
    if title:
        lines.append(title)
        lines.append("-" * len(title))
    _render(stats, 0, lines)
    return "\n".join(lines)


def print_stats(stats: Any, title: str = "") -> None:
    print(format_stats(stats, title))
