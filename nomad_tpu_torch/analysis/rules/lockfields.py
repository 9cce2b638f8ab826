"""NTA005 — class-level lock discipline.

If a class guards ``self.x`` with ``with self._lock:`` in one method,
then a lock-free ``self.x`` read or write in *another* method of the same
class is (at best) a benign race waiting for a refactor to make it
malign. The threaded commit path lives on exactly this invariant: the
worker's stats, the shared overlay's counters, and the store's watermark
are all guarded fields.

Analysis, per class:
1. lock attributes: ``self.X = threading.Lock()/RLock()/Condition()``
   (dotted or bare-imported) anywhere in the class;
2. guarded fields: every ``self.Y`` *written* inside a ``with self.X:``
   block (plain stores, aug-assigns, and stores through a subscript like
   ``self.stats[k] += 1`` all count);
3. violations: any access (read or write) to a guarded field outside a
   ``with self.X:`` block, in any method other than ``__init__`` /
   ``__new__`` (pre-publication construction is single-threaded by
   definition).

Methods whose name ends in ``_locked`` are exempt — that suffix is the
documented convention for "caller holds the lock".

Scope: ``nomad_tpu_torch/server/``, ``nomad_tpu_torch/broker/``, ``nomad_tpu_torch/state/``,
and ``nomad_tpu_torch/utils/metrics.py``.
"""

from __future__ import annotations

import ast
from typing import Optional

from ..lint import Finding, Rule, dotted_name

_LOCK_FACTORIES = {
    "threading.Lock", "threading.RLock", "threading.Condition",
    "Lock", "RLock", "Condition",
}


def _self_attr(node: ast.AST) -> Optional[str]:
    if (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
    ):
        return node.attr
    return None


def _find_lock_attrs(cls: ast.ClassDef) -> set[str]:
    locks: set[str] = set()
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            fname = dotted_name(node.value.func)
            if fname in _LOCK_FACTORIES:
                for t in node.targets:
                    attr = _self_attr(t)
                    if attr:
                        locks.add(attr)
    return locks


class _Access:
    __slots__ = ("field", "method", "line", "write", "locks")

    def __init__(self, field, method, line, write, locks):
        self.field = field
        self.method = method
        self.line = line
        self.write = write
        self.locks = locks  # frozenset of lock attrs held at the access


class _MethodScanner(ast.NodeVisitor):
    def __init__(self, method: str, lock_attrs: set[str]):
        self.method = method
        self.lock_attrs = lock_attrs
        self.held: list[str] = []
        self.accesses: list[_Access] = []

    def _record(self, field: str, node: ast.AST, write: bool) -> None:
        self.accesses.append(
            _Access(
                field, self.method, getattr(node, "lineno", 0), write,
                frozenset(self.held),
            )
        )

    def visit_With(self, node: ast.With) -> None:
        acquired = []
        for item in node.items:
            attr = _self_attr(item.context_expr)
            if attr and attr in self.lock_attrs:
                acquired.append(attr)
        self.held.extend(acquired)
        for stmt in node.body:
            self.visit(stmt)
        if acquired:
            del self.held[len(self.held) - len(acquired):]

    def visit_Attribute(self, node: ast.Attribute) -> None:
        attr = _self_attr(node)
        if attr and attr not in self.lock_attrs:
            self._record(attr, node, isinstance(node.ctx, ast.Store))
        self.generic_visit(node)

    def visit_Assign(self, node: ast.Assign) -> None:
        # self.stats[k] = v / self.obj.field = v: a store through a chain
        # is a WRITE to the self attribute at its base
        for t in node.targets:
            self._mark_chain_write(t)
        self.generic_visit(node)

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        self._mark_chain_write(node.target)
        self.generic_visit(node)

    def _mark_chain_write(self, target: ast.AST) -> None:
        node = target
        while isinstance(node, (ast.Subscript, ast.Attribute)):
            parent = node.value
            attr = _self_attr(parent) if node is not target else None
            if attr and attr not in self.lock_attrs:
                self._record(attr, parent, True)
                return
            node = parent


class LockDiscipline(Rule):
    id = "NTA005"
    title = "fields written under a lock must never be accessed lock-free"

    def applies_to(self, relpath: str) -> bool:
        return (
            relpath.startswith("nomad_tpu_torch/server/")
            or relpath.startswith("nomad_tpu_torch/broker/")
            or relpath.startswith("nomad_tpu_torch/state/")
            or relpath == "nomad_tpu_torch/utils/metrics.py"
        )

    def check(self, tree, source, relpath) -> list[Finding]:
        findings: list[Finding] = []
        for cls in [
            n for n in ast.walk(tree) if isinstance(n, ast.ClassDef)
        ]:
            lock_attrs = _find_lock_attrs(cls)
            if not lock_attrs:
                continue
            accesses: list[_Access] = []
            for item in cls.body:
                if not isinstance(
                    item, (ast.FunctionDef, ast.AsyncFunctionDef)
                ):
                    continue
                if item.name in ("__init__", "__new__"):
                    continue
                if item.name.endswith("_locked"):
                    continue  # convention: caller holds the lock
                scanner = _MethodScanner(item.name, lock_attrs)
                for stmt in item.body:
                    scanner.visit(stmt)
                accesses.extend(scanner.accesses)

            # guarded = written under at least one lock somewhere
            guarded: dict[str, str] = {}
            for a in accesses:
                if a.write and a.locks:
                    guarded.setdefault(a.field, sorted(a.locks)[0])

            seen: set[tuple[str, str]] = set()
            for a in accesses:
                lock = guarded.get(a.field)
                if lock is None or a.locks:
                    continue
                key = (a.method, a.field)
                if key in seen:
                    continue
                seen.add(key)
                kind = "written" if a.write else "read"
                findings.append(
                    Finding(
                        rule="NTA005",
                        path=relpath,
                        line=a.line,
                        symbol=f"{cls.name}.{a.method}",
                        message=(
                            f"field '{a.field}' is guarded by "
                            f"'self.{lock}' elsewhere in {cls.name} but "
                            f"{kind} lock-free here"
                        ),
                    )
                )
        return findings
