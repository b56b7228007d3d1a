"""Strict, centralised ``REPRO_*`` environment-variable parsing.

Every knob the engine / serving / benchmark layers read from the
environment goes through one of these helpers.  The historical parsers
were permissive in the dangerous direction: ``REPRO_ENGINE_PACK=offf``
(a typo) silently meant *on*, and ``REPRO_ENGINE_MAX_CHUNK=1k`` raised
a bare ``ValueError`` from ``int()`` deep inside plan construction.
Here garbage raises a :class:`ValueError` naming the variable, the
offending value, and what would have been accepted — at the *first*
read, not after a plan half-built itself around a default.

Unset variables always mean the documented default; the helpers never
read anything but ``os.environ``.
"""

import os
from typing import Optional, Sequence, Tuple

__all__ = [
    "env_flag", "env_int", "env_float", "env_choice", "env_gate",
    "env_path",
]

#: accepted spellings for boolean-ish flags (case-insensitive)
_TRUE: Tuple[str, ...] = ("1", "true", "on", "yes")
_FALSE: Tuple[str, ...] = ("0", "false", "off", "no")


def _bad(name: str, raw: str, expected: str) -> ValueError:
    return ValueError(
        f"invalid {name}={raw!r}: expected {expected} "
        f"(unset the variable for the default)")


def env_flag(name: str, default: bool, *,
             auto_means_default: bool = True) -> bool:
    """Boolean flag: ``1/true/on/yes`` vs ``0/false/off/no``.

    ``auto`` maps to the default when ``auto_means_default`` — the
    engine kill switches document ``auto`` as "engine decides", which
    is exactly the unset behaviour.
    """
    raw = os.environ.get(name)
    if raw is None:
        return default
    v = raw.strip().lower()
    if auto_means_default and v == "auto":
        return default
    if v in _TRUE:
        return True
    if v in _FALSE:
        return False
    expected = "one of " + "/".join(_TRUE + _FALSE)
    if auto_means_default:
        expected += " (or 'auto')"
    raise _bad(name, raw, expected)


def env_int(name: str, default: int, *,
            min_value: Optional[int] = None,
            max_value: Optional[int] = None) -> int:
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        v = int(raw.strip())
    except ValueError:
        raise _bad(name, raw, "an integer") from None
    if min_value is not None and v < min_value:
        raise _bad(name, raw, f"an integer >= {min_value}")
    if max_value is not None and v > max_value:
        raise _bad(name, raw, f"an integer <= {max_value}")
    return v


def env_float(name: str, default: float, *,
              min_value: Optional[float] = None) -> float:
    raw = os.environ.get(name)
    if raw is None:
        return default
    try:
        v = float(raw.strip())
    except ValueError:
        raise _bad(name, raw, "a number") from None
    if v != v:      # NaN poisons every comparison downstream
        raise _bad(name, raw, "a number (not NaN)")
    if min_value is not None and v < min_value:
        raise _bad(name, raw, f"a number >= {min_value}")
    return v


def env_choice(name: str, default: str, choices: Sequence[str]) -> str:
    raw = os.environ.get(name)
    if raw is None:
        return default
    v = raw.strip().lower()
    if v not in choices:
        raise _bad(name, raw, "one of " + "/".join(choices))
    return v


def env_path(name: str, default: Optional[str] = None) -> Optional[str]:
    """Filesystem-path knob.  An empty or whitespace-only value is a
    shell quoting accident (``REPRO_TRACE= python ...``), not a request
    to write to ``""`` — it raises rather than silently disabling or
    producing an unopenable path."""
    raw = os.environ.get(name)
    if raw is None:
        return default
    if not raw.strip():
        raise _bad(name, raw, "a non-empty filesystem path")
    return raw


def env_gate(name: str, auto: float) -> float:
    """Benchmark acceptance-gate knob: ``auto`` -> the suite's default
    threshold, ``off``/``0`` -> disabled (0.0), otherwise a float."""
    raw = os.environ.get(name)
    if raw is None:
        return auto
    v = raw.strip().lower()
    if v == "auto":
        return auto
    if v in _FALSE:
        return 0.0
    try:
        return float(v)
    except ValueError:
        raise _bad(name, raw, "'auto', 'off', or a number") from None
