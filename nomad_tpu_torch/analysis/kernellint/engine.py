"""Analyzer driver: exercise the fleet twice, run the JXL rules, ratchet.

The port of ``nomad_tpu/analysis/jaxlint/engine.py``. Mirrors the NTA
source-lint engine (``analysis.lint``): findings carry line-free
fingerprints, ``baseline.json`` next to this module is the
accepted-debt ledger (empty: a finding is repaired in the wrapper), new
findings fail, fixed findings are pruned with ``--fix-baseline``. The
two engines share the Finding type and baseline format so
``python -m nomad_tpu_torch.analysis`` can combine them in one run.
"""

from __future__ import annotations

from pathlib import Path

from ..lint import (
    Finding,
    diff_against_baseline,
    load_baseline,
    write_baseline,
)
from . import rules
from .fingerprint import kernel_configs


def default_baseline_path() -> Path:
    return Path(__file__).resolve().parent / "baseline.json"


def _by_kernel(calls) -> dict:
    out: dict = {}
    for c in calls:
        out.setdefault(c.name, []).append(c)
    return out


def analyze_kernels(device="cuda") -> tuple[list[Finding], dict]:
    """Run JXL003-JXL005 over every kernel of the fleet, on ``device``
    (the card by default; without CUDA that raises — ``"cpu"`` runs the
    plain versions).

    The fleet (``kernellint.exercise``) runs twice: the first run's
    calls are audited for dtypes, the second must equal it bit for bit
    and start no build. Returns ``(findings, reports)``; ``reports``
    maps kernel name to its route, library and symbols, build budget,
    calls a run, builds (before and in the second run) and
    ``configs`` ({label: fingerprint})."""
    from ... import backend
    from .. import retrace
    from .exercise import exercise_fleet
    from .registry import import_fleet, production_kernels

    dev = backend.resolve_device(device)
    registry = import_fleet()
    if dev.type == "cuda":
        backend.build_all()  # one nvcc a source, all started together
    first = _by_kernel(exercise_fleet(dev))
    before = retrace.counts()
    second = _by_kernel(exercise_fleet(dev))
    after = retrace.counts()

    findings: list[Finding] = []
    reports: dict[str, dict] = {}
    for name, entry in production_kernels(registry).items():
        a, b = first.get(name, []), second.get(name, [])
        builds = after.get(entry.guard, 0) - before.get(entry.guard, 0)
        if entry.guard != name:
            builds = 0  # its builds are filed under the outer guard's
        kernel_findings = rules.check_kernel(entry, a, b, builds)
        reports[name] = {
            "route": entry.route,
            "library": entry.library,
            "symbols": list(entry.symbols),
            "guard": entry.guard,
            "build_budget": entry.build_budget,
            "calls": len(a),
            "builds": before.get(name, 0) if entry.guard == name else 0,
            "second_pass_builds": builds,
            "configs": kernel_configs(entry),
            "findings": len(kernel_findings),
        }
        findings.extend(kernel_findings)
    findings.sort(key=lambda f: (f.path, f.symbol, f.rule, f.message))
    return findings, reports


def run_kernellint(
    baseline_path: Path | None = None,
    fix_baseline: bool = False,
    device="cuda",
) -> tuple[int, list[Finding], set[str], dict]:
    """Full ratcheted run. Returns (exit_code, new_findings,
    fixed_fingerprints, per-kernel reports)."""
    path = baseline_path or default_baseline_path()
    findings, reports = analyze_kernels(device)
    baseline = load_baseline(path)
    new, fixed = diff_against_baseline(findings, baseline)
    if fix_baseline:
        write_baseline(findings, path)
        return 0, new, fixed, reports
    return (1 if new else 0), new, fixed, reports
