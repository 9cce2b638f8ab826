"""NTA011 — no unbounded in-memory accumulation in obs/broker/server.

A list or dict that only ever grows is a slow memory leak with a
latency tail: the steady-state soak (obs/loadgen.py) runs the cluster
for minutes at hundreds of events per second, and any per-event append
without an eviction bound eventually dominates RSS and GC pauses — the
exact failure the bounded LogHistogram/TimeSeriesRing plane
(utils/hist.py) exists to prevent. Every long-lived container in these
modules must have an eviction story: a cap-and-trim, a pop/del path, a
``deque(maxlen=...)``, or a bounded structure by construction.

Flagged, per class (``self.X``) and per module-level container:
- growth calls (``append``/``extend``/``insert``/``appendleft``/
  ``setdefault``/``add``) against an attribute or module-level
  container with **no** eviction evidence anywhere in the same class /
  module: ``pop``/``popitem``/``popleft``/``remove``/``clear``/
  ``discard``, a ``del x[...]`` (index or slice), or a rebuild
  assignment outside ``__init__``.
- containers initialized as ``deque(maxlen=...)`` or as bounded
  telemetry types (``LogHistogram``, ``TimeSeriesRing``) are bounded by
  construction and never flagged.

Scope: ``nomad_tpu_torch/obs/``, ``nomad_tpu_torch/broker/``, ``nomad_tpu_torch/server/``.
"""

from __future__ import annotations

import ast

from ..lint import Finding, Rule, ScopedVisitor, dotted_name

_GROW = {"append", "extend", "insert", "appendleft", "setdefault", "add"}
_EVICT = {"pop", "popitem", "popleft", "remove", "clear", "discard"}
# bounded by construction: fixed-capacity telemetry primitives
_BOUNDED_TYPES = {"LogHistogram", "TimeSeriesRing"}
_CONTAINER_TYPES = {
    "list", "dict", "set", "defaultdict", "OrderedDict", "deque",
}


def _is_bounded_ctor(value: ast.AST) -> bool:
    """deque(maxlen=...) or a bounded telemetry type."""
    if not isinstance(value, ast.Call):
        return False
    name = (dotted_name(value.func) or "").split(".")[-1]
    if name in _BOUNDED_TYPES:
        return True
    if name == "deque":
        return any(kw.arg == "maxlen" for kw in value.keywords)
    return False


def _is_container_init(value: ast.AST) -> bool:
    if isinstance(value, (ast.List, ast.Dict, ast.Set, ast.ListComp,
                          ast.DictComp, ast.SetComp)):
        return True
    if isinstance(value, ast.Call):
        name = (dotted_name(value.func) or "").split(".")[-1]
        return name in _CONTAINER_TYPES
    return False


class _Visitor(ScopedVisitor):
    """One pass per class scope (plus the module scope for top-level
    containers): collect growth sites and eviction evidence, flag the
    growth sites whose target never sees an eviction."""

    def __init__(self, relpath: str, module_containers: set[str]):
        super().__init__(relpath)
        self._module_containers = module_containers
        self._class_stack: list[str] = []
        # (scope, target) → first growth call node
        self._grown: dict[tuple[str, str], ast.AST] = {}
        self._evicted: set[tuple[str, str]] = set()
        self._bounded: set[tuple[str, str]] = set()
        self._func_stack: list[str] = []
        # local name → tracked key, for `s = self.x.get(k)` /
        # `s = self.x[k]` aliases: an eviction through the alias
        # (s.clear()) credits the underlying container
        self._aliases: dict[tuple[str, str], tuple[str, str]] = {}

    def _cls(self) -> str:
        return self._class_stack[-1] if self._class_stack else ""

    def _target_key(self, obj: ast.AST) -> tuple[str, str] | None:
        """(scope, target) for direct ``self.X`` attributes and
        module-level containers. Deeper paths (``self.a.b``) belong to
        another object whose own class owns the eviction story; locals
        and other expressions return None."""
        name = dotted_name(obj)
        if not name:
            return None
        if (
            name.startswith("self.")
            and name.count(".") == 1
            and self._class_stack
        ):
            return (self._cls(), name)
        if "." not in name and name in self._module_containers:
            return ("", name)
        return None

    def _alias_key(self, obj: ast.AST) -> tuple[str, str] | None:
        """Resolve a bare local name through the alias map."""
        if isinstance(obj, ast.Name):
            return self._aliases.get((self._cls(), obj.id))
        return None

    def visit_ClassDef(self, node: ast.ClassDef) -> None:
        self._class_stack.append(node.name)
        self._push(node.name, node)
        self._class_stack.pop()

    def visit_FunctionDef(self, node: ast.FunctionDef) -> None:
        self._func_stack.append(node.name)
        self._push(node.name, node)
        self._func_stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    def visit_Call(self, node: ast.Call) -> None:
        if isinstance(node.func, ast.Attribute):
            key = self._target_key(node.func.value)
            if key is not None:
                if node.func.attr in _GROW:
                    self._grown.setdefault(key, node)
                elif node.func.attr in _EVICT:
                    self._evicted.add(key)
            elif node.func.attr in _EVICT:
                alias = self._alias_key(node.func.value)
                if alias is not None:
                    self._evicted.add(alias)
        self.generic_visit(node)

    def visit_Delete(self, node: ast.Delete) -> None:
        for t in node.targets:
            if isinstance(t, ast.Subscript):
                key = self._target_key(t.value)
                if key is not None:
                    self._evicted.add(key)
        self.generic_visit(node)

    def visit_Assign(self, node: ast.Assign) -> None:
        for t in node.targets:
            key = None
            if isinstance(t, ast.Subscript):
                # slice assignment (x[:] = ...) trims in place; keyed
                # assignment grows a dict
                if isinstance(t.slice, ast.Slice):
                    key = self._target_key(t.value)
                    if key is not None:
                        self._evicted.add(key)
                continue
            if isinstance(t, ast.Name):
                src = self._read_source_key(node.value)
                if src is not None:
                    self._aliases[(self._cls(), t.id)] = src
            key = self._target_key(t)
            if key is None:
                continue
            if _is_bounded_ctor(node.value):
                self._bounded.add(key)
            elif self._func_stack and self._func_stack[-1] != "__init__":
                # rebuild outside __init__ (e.g. x = [v for v in x if
                # keep(v)]) is an eviction path
                self._evicted.add(key)
        self.generic_visit(node)

    def _read_source_key(self, value: ast.AST) -> tuple[str, str] | None:
        """The tracked container a read expression drills into:
        ``self.x[k]``, ``self.x.get(k)``, ``self.x.setdefault(k, …)``."""
        if isinstance(value, ast.Subscript):
            return self._target_key(value.value)
        if (
            isinstance(value, ast.Call)
            and isinstance(value.func, ast.Attribute)
            and value.func.attr in ("get", "setdefault")
        ):
            return self._target_key(value.func.value)
        return None

    def findings_for_module(self) -> list[Finding]:
        for key, node in sorted(
            self._grown.items(), key=lambda kv: kv[1].lineno
        ):
            if key in self._evicted or key in self._bounded:
                continue
            scope, target = key
            where = f"{scope}.{target}" if scope else target
            self.add(
                "NTA011",
                node,
                f"unbounded accumulation: {where} only ever grows in "
                f"this {'class' if scope else 'module'} — cap it "
                f"(deque(maxlen=), trim-on-insert, LogHistogram/"
                f"TimeSeriesRing) or add an eviction path",
            )
        return self.findings


def _module_container_names(tree: ast.Module) -> set[str]:
    """Names bound at module top level to a list/dict/set — the only
    module-level targets the rule tracks (locals named the same inside
    functions don't alias these; growth is matched by name, which is
    the same heuristic scoping the repo's other rules use)."""
    out: set[str] = set()
    for stmt in tree.body:
        targets = []
        if isinstance(stmt, ast.Assign):
            targets = [
                t.id for t in stmt.targets if isinstance(t, ast.Name)
            ]
            value = stmt.value
        elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
            if isinstance(stmt.target, ast.Name):
                targets = [stmt.target.id]
            value = stmt.value
        else:
            continue
        if targets and _is_container_init(value) and not _is_bounded_ctor(
            value
        ):
            out.update(targets)
    return out


class UnboundedAccumulation(Rule):
    id = "NTA011"
    title = "no unbounded in-memory accumulation in obs/broker/server"

    def applies_to(self, relpath: str) -> bool:
        return (
            relpath.startswith("nomad_tpu_torch/obs/")
            or relpath.startswith("nomad_tpu_torch/broker/")
            or relpath.startswith("nomad_tpu_torch/server/")
        )

    def check(self, tree, source, relpath) -> list[Finding]:
        v = _Visitor(relpath, _module_container_names(tree))
        v.visit(tree)
        return v.findings_for_module()
