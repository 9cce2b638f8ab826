"""AST lint engine: findings, rule registry, baseline ratchet, runner.

The engine is deliberately boring: every rule is an ``ast`` walk over one
file, a finding is a (rule, path, symbol, message) tuple, and the whole
repo is analyzed from scratch on every run (~100 files parses in well
under a second). The interesting part is the *ratchet*: findings are
fingerprinted WITHOUT line numbers, so unrelated edits never churn the
baseline, and a violation only leaves the baseline when the code it
points at is actually fixed (or ``--fix-baseline`` is run).

Inline suppression: a line containing ``# nta: allow`` waives every rule
for findings anchored on that line; ``# nta: allow=NTA001,NTA005`` waives
only the named rules. Use sparingly — the comment is the audit trail.
"""

from __future__ import annotations

import ast
import json
import re
from dataclasses import dataclass
from pathlib import Path
from typing import Iterable, Optional

_ALLOW_RE = re.compile(r"#\s*nta:\s*allow(?:=([A-Za-z0-9_,]+))?")

# directories under the repo root that the default whole-repo run scans
DEFAULT_SCAN_DIRS = ("nomad_tpu_torch",)


@dataclass(frozen=True)
class Finding:
    rule: str
    path: str  # repo-relative, posix separators
    line: int
    symbol: str  # enclosing Class.method / function qualname ("" = module)
    message: str

    @property
    def fingerprint(self) -> str:
        """Line-free ratchet key: survives unrelated edits to the file."""
        return f"{self.rule}:{self.path}:{self.symbol}:{self.message}"

    def render(self) -> str:
        where = f" (in {self.symbol})" if self.symbol else ""
        return f"{self.path}:{self.line}: {self.rule} {self.message}{where}"


class Rule:
    """Base class for repo-specific rules. Subclasses set ``id`` and
    ``title``, implement ``applies_to`` (path scoping) and ``check``."""

    id: str = ""
    title: str = ""

    def applies_to(self, relpath: str) -> bool:
        raise NotImplementedError

    def check(self, tree: ast.AST, source: str, relpath: str) -> list[Finding]:
        raise NotImplementedError


class ScopedVisitor(ast.NodeVisitor):
    """NodeVisitor that tracks the enclosing class/function qualname so
    rules can anchor findings on a stable symbol instead of a line."""

    def __init__(self, relpath: str):
        self.relpath = relpath
        self._scope: list[str] = []
        self.findings: list[Finding] = []

    def qualname(self) -> str:
        return ".".join(self._scope)

    def _push(self, name: str, node: ast.AST) -> None:
        self._scope.append(name)
        self.generic_visit(node)
        self._scope.pop()

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._push(node.name, node)

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._push(node.name, node)

    def visit_AsyncFunctionDef(self, node: ast.AsyncFunctionDef) -> None:
        self._push(node.name, node)

    def add(self, rule_id: str, node: ast.AST, message: str) -> None:
        self.findings.append(
            Finding(
                rule=rule_id,
                path=self.relpath,
                line=getattr(node, "lineno", 0),
                symbol=self.qualname(),
                message=message,
            )
        )


def dotted_name(node: ast.AST) -> Optional[str]:
    """'time.time' for Attribute(Name('time'), 'time'); None for dynamic
    bases (calls, subscripts) the rules can't resolve statically."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def suppressed_lines(source: str) -> dict[int, Optional[set[str]]]:
    """line number -> None (allow all rules) or set of allowed rule ids."""
    out: dict[int, Optional[set[str]]] = {}
    for i, text in enumerate(source.splitlines(), start=1):
        m = _ALLOW_RE.search(text)
        if not m:
            continue
        if m.group(1):
            out[i] = {r.strip().upper() for r in m.group(1).split(",")}
        else:
            out[i] = None
    return out


def _apply_suppressions(
    findings: list[Finding], source: str
) -> list[Finding]:
    allow = suppressed_lines(source)
    if not allow:
        return findings
    kept = []
    for f in findings:
        rules = allow.get(f.line, "missing")
        if rules == "missing":
            kept.append(f)
        elif rules is not None and f.rule not in rules:
            kept.append(f)
    return kept


# -- runner ----------------------------------------------------------------


def all_rules() -> list[Rule]:
    from .rules import REGISTRY

    return [cls() for cls in REGISTRY]


def check_source(
    source: str, relpath: str, rules: Optional[Iterable[Rule]] = None
) -> list[Finding]:
    """Lint one in-memory source blob as if it lived at ``relpath``
    (repo-relative). This is the fixture seam the rule tests use."""
    relpath = relpath.replace("\\", "/")
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [
            Finding(
                rule="NTA000",
                path=relpath,
                line=e.lineno or 0,
                symbol="",
                message=f"syntax error: {e.msg}",
            )
        ]
    findings: list[Finding] = []
    for rule in rules if rules is not None else all_rules():
        if rule.applies_to(relpath):
            findings.extend(rule.check(tree, source, relpath))
    findings = _apply_suppressions(findings, source)
    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.message))
    return findings


def iter_python_files(root: Path) -> list[Path]:
    files: list[Path] = []
    for d in DEFAULT_SCAN_DIRS:
        base = root / d
        if base.is_dir():
            files.extend(base.rglob("*.py"))
    return sorted(files)


def run_lint(
    root: Path,
    paths: Optional[Iterable[Path]] = None,
    rules: Optional[Iterable[Rule]] = None,
) -> list[Finding]:
    root = Path(root).resolve()
    rules = list(rules) if rules is not None else all_rules()
    targets = (
        [Path(p).resolve() for p in paths]
        if paths
        else iter_python_files(root)
    )
    findings: list[Finding] = []
    for path in targets:
        try:
            relpath = path.relative_to(root).as_posix()
        except ValueError:
            relpath = path.as_posix()
        findings.extend(
            check_source(path.read_text(encoding="utf-8"), relpath, rules)
        )
    findings.sort(key=lambda f: (f.path, f.line, f.rule, f.message))
    return findings


# -- baseline ratchet -------------------------------------------------------


def default_baseline_path() -> Path:
    return Path(__file__).resolve().parent / "baseline.json"


def repo_root() -> Path:
    """Directory containing the ``nomad_tpu_torch`` package."""
    return Path(__file__).resolve().parents[2]


def load_baseline(path: Path) -> set[str]:
    path = Path(path)
    if not path.exists():
        return set()
    data = json.loads(path.read_text(encoding="utf-8"))
    return {e["fingerprint"] for e in data.get("entries", [])}


def write_baseline(findings: list[Finding], path: Path) -> None:
    entries = sorted(
        (
            {
                "fingerprint": f.fingerprint,
                "rule": f.rule,
                "path": f.path,
                "symbol": f.symbol,
                "message": f.message,
            }
            for f in findings
        ),
        key=lambda e: e["fingerprint"],
    )
    # dedupe identical fingerprints (e.g. the same message on two lines):
    # the ratchet tracks presence, not multiplicity
    seen: set[str] = set()
    unique = []
    for e in entries:
        if e["fingerprint"] not in seen:
            seen.add(e["fingerprint"])
            unique.append(e)
    Path(path).write_text(
        json.dumps({"version": 1, "entries": unique}, indent=2) + "\n",
        encoding="utf-8",
    )


def diff_against_baseline(
    findings: list[Finding], baseline: set[str]
) -> tuple[list[Finding], set[str]]:
    """Returns (new findings not in baseline, baseline fingerprints that
    no longer fire — i.e. fixed and eligible for --fix-baseline)."""
    fps = {f.fingerprint for f in findings}
    new = [f for f in findings if f.fingerprint not in baseline]
    fixed = baseline - fps
    return new, fixed
