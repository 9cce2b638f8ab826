"""Minimal 5-field cron evaluator (minute hour dom month dow).

Backs the periodic dispatcher (the reference uses gorhill/cronexpr via
nomad/periodic.go). Supports: ``*``, lists ``a,b``, ranges ``a-b``, and
steps ``*/n`` / ``a-b/n``. All times UTC.
"""

from __future__ import annotations

import calendar
from datetime import datetime, timedelta, timezone

_FIELDS = (
    ("minute", 0, 59),
    ("hour", 0, 23),
    ("dom", 1, 31),
    ("month", 1, 12),
    ("dow", 0, 6),  # 0 = Sunday
)


class CronParseError(ValueError):
    pass


def _parse_field(expr: str, lo: int, hi: int) -> frozenset[int]:
    out: set[int] = set()
    for part in expr.split(","):
        step = 1
        if "/" in part:
            part, step_s = part.split("/", 1)
            try:
                step = int(step_s)
            except ValueError:
                raise CronParseError(f"bad step {step_s!r}") from None
            if step <= 0:
                raise CronParseError("step must be positive")
        if part in ("*", ""):
            lo2, hi2 = lo, hi
        elif "-" in part:
            a, b = part.split("-", 1)
            try:
                lo2, hi2 = int(a), int(b)
            except ValueError:
                raise CronParseError(f"bad range {part!r}") from None
        else:
            try:
                lo2 = hi2 = int(part)
            except ValueError:
                raise CronParseError(f"bad value {part!r}") from None
        if lo2 < lo or hi2 > hi or lo2 > hi2:
            raise CronParseError(f"value out of range: {part!r}")
        out.update(range(lo2, hi2 + 1, step))
    return frozenset(out)


class Cron:
    def __init__(self, spec: str):
        fields = spec.split()
        if len(fields) != 5:
            raise CronParseError(
                f"cron spec needs 5 fields, got {len(fields)}: {spec!r}"
            )
        self.minute = _parse_field(fields[0], 0, 59)
        self.hour = _parse_field(fields[1], 0, 23)
        self.dom = _parse_field(fields[2], 1, 31)
        self.month = _parse_field(fields[3], 1, 12)
        self.dow = _parse_field(fields[4], 0, 6)
        self._dom_wild = fields[2] == "*"
        self._dow_wild = fields[4] == "*"

    def _day_match(self, dt: datetime) -> bool:
        dom_ok = dt.day in self.dom
        dow_ok = ((dt.weekday() + 1) % 7) in self.dow  # python Mon=0 → cron Sun=0
        if self._dom_wild and self._dow_wild:
            return True
        if self._dom_wild:
            return dow_ok
        if self._dow_wild:
            return dom_ok
        return dom_ok or dow_ok  # vixie-cron OR semantics

    def next_after(self, after: float) -> float:
        """Next firing (unix seconds) strictly after ``after``."""
        dt = datetime.fromtimestamp(after, tz=timezone.utc).replace(
            second=0, microsecond=0
        ) + timedelta(minutes=1)
        for _ in range(366 * 24 * 60):  # bounded search: one year of minutes
            if (
                dt.month in self.month
                and self._day_match(dt)
                and dt.hour in self.hour
                and dt.minute in self.minute
            ):
                return dt.timestamp()
            dt += timedelta(minutes=1)
        raise CronParseError("no firing within a year")
