"""NTA002 — no host syncs on a kernel's launch path.

The port of ``nomad_tpu/analysis/rules/hostsync.py``. The reference
guards the bodies of its ``jax.jit`` kernels, where a ``.item()`` or a
Python cast forces a device→host round trip per step. The port's device
programs are hand-written kernels, so what can stall the card is the
Python around the launch: a ``.item()``, ``.tolist()``, ``.cpu()`` or
``.numpy()``, a ``float()`` / ``int()`` / ``bool()`` of a tensor, or a
``torch.cuda.synchronize()`` between a wrapper's entry and its launch
makes the host wait for every queued kernel before it can queue the
next, and turns a pass of back-to-back launches into a launch, a wait,
a launch. The kernel guard's one event synchronize (``backend.py``) is
where the wait belongs.

Scope: the kernel modules ``device/score.py``, ``device/score_triton.py``,
``device/preempt.py``, ``device/cp.py``, ``device/migrate.py`` and
``scheduler/hetero.py``. Checked: the CUDA branch of every ``@guarded``
wrapper (the function and the calls named in the decorator's
arguments), every function that counts a launch (``count_launch``), and
every function of the same module they call, transitively. A CPU branch
(``if <x>.type == "cpu": ...``; the body of ``!= "cuda"``) and the plain
versions (``*_plain``) are exempt: they run on the CPU by design.

A cast counts as "of a tensor" when its argument calls a tensor
reduction or conversion (``.any()``, ``.sum()``, ``.max()``, …) or a
``torch.*`` function; shape reads (``.shape``, ``.dtype``, ``.numel()``,
``len``) are not syncs and are never flagged.
"""

from __future__ import annotations

import ast

from ..lint import Finding, Rule, ScopedVisitor, dotted_name

_KERNEL_MODULES = (
    "nomad_tpu_torch/device/score.py",
    "nomad_tpu_torch/device/score_triton.py",
    "nomad_tpu_torch/device/preempt.py",
    "nomad_tpu_torch/device/cp.py",
    "nomad_tpu_torch/device/migrate.py",
    "nomad_tpu_torch/scheduler/hetero.py",
)

_GUARD_NAMES = {"guarded", "backend.guarded"}
_LAUNCH_COUNTERS = {"count_launch", "backend.count_launch"}
_SYNC_METHODS = ("item", "tolist", "cpu", "numpy")
_CAST_BUILTINS = {"float", "int", "bool"}
# tensor methods whose result is a device tensor a cast would read back
_TENSOR_OPS = {
    "any", "all", "sum", "max", "min", "amax", "amin", "argmax", "argmin",
    "mean", "prod", "count_nonzero", "norm", "nonzero", "abs", "clone",
    "to", "cuda", "long", "int", "float", "double", "half",
}


def _is_guard(dec: ast.AST) -> bool:
    target = dec.func if isinstance(dec, ast.Call) else dec
    return dotted_name(target) in _GUARD_NAMES


def _device_type_test(test: ast.AST):
    """"cpu" when the ``if`` body is the CPU branch, "cuda" when it is
    the CUDA branch, None when the test does not compare a device type."""
    if not (
        isinstance(test, ast.Compare)
        and len(test.ops) == 1
        and isinstance(test.left, ast.Attribute)
        and test.left.attr == "type"
        and isinstance(test.comparators[0], ast.Constant)
    ):
        return None
    value, op = test.comparators[0].value, test.ops[0]
    if isinstance(op, ast.Eq):
        return {"cpu": "cpu", "cuda": "cuda"}.get(value)
    if isinstance(op, ast.NotEq):
        return {"cpu": "cuda", "cuda": "cpu"}.get(value)
    return None


def _tensor_valued(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if not isinstance(sub, ast.Call):
            continue
        if isinstance(sub.func, ast.Attribute) and sub.func.attr in _TENSOR_OPS:
            return True
        name = dotted_name(sub.func) or ""
        if name.startswith("torch."):
            return True
    return False


class _LaunchVisitor(ScopedVisitor):
    """Walks one launch-path function body, CPU branches skipped; notes
    the module-local names it calls."""

    def __init__(self, relpath: str):
        super().__init__(relpath)
        self.calls: set[str] = set()

    def visit_If(self, node: ast.If) -> None:
        branch = _device_type_test(node.test)
        self.visit(node.test)
        if branch != "cpu":
            for stmt in node.body:
                self.visit(stmt)
        if branch != "cuda":
            for stmt in node.orelse:
                self.visit(stmt)

    def visit_Call(self, node: ast.Call) -> None:
        if isinstance(node.func, ast.Name):
            self.calls.add(node.func.id)
        if (
            isinstance(node.func, ast.Attribute)
            and node.func.attr in _SYNC_METHODS
            and not node.args
        ):
            self.add(
                "NTA002", node,
                f"host sync: .{node.func.attr}() on a kernel's launch path",
            )
        name = dotted_name(node.func) or ""
        if name.endswith("cuda.synchronize") or (
            isinstance(node.func, ast.Attribute) and node.func.attr == "synchronize"
        ):
            self.add(
                "NTA002", node,
                "host sync: synchronize() on a kernel's launch path (the "
                "kernel guard waits on the launch's event)",
            )
        elif (
            name in _CAST_BUILTINS
            and len(node.args) == 1
            and _tensor_valued(node.args[0])
        ):
            self.add(
                "NTA002", node,
                f"host sync: {name}() of a tensor on a kernel's launch path",
            )
        self.generic_visit(node)


class _Module:
    """The module's top-level functions and classes, and the roots of
    its launch paths."""

    def __init__(self, tree: ast.Module):
        self.functions: dict[str, ast.FunctionDef] = {}
        self.classes: dict[str, ast.ClassDef] = {}
        self.roots: list[str] = []
        self.decorator_calls: dict[str, set[str]] = {}
        for node in tree.body:
            if isinstance(node, ast.FunctionDef):
                self.functions[node.name] = node
                guards = [d for d in node.decorator_list if _is_guard(d)]
                if guards:
                    self.roots.append(node.name)
                    self.decorator_calls[node.name] = {
                        sub.func.id
                        for d in guards
                        for sub in ast.walk(d)
                        if isinstance(sub, ast.Call) and isinstance(sub.func, ast.Name)
                    }
                elif any(
                    isinstance(sub, ast.Call) and dotted_name(sub.func) in _LAUNCH_COUNTERS
                    for sub in ast.walk(node)
                ):
                    self.roots.append(node.name)
            elif isinstance(node, ast.ClassDef):
                self.classes[node.name] = node


class HostSyncInJitKernel(Rule):
    id = "NTA002"
    title = "no host syncs on a kernel's launch path"

    def applies_to(self, relpath: str) -> bool:
        return relpath in _KERNEL_MODULES

    def check(self, tree, source, relpath) -> list[Finding]:
        mod = _Module(tree)
        findings: list[Finding] = []
        seen: set[str] = set()
        todo = list(mod.roots)
        for root in mod.roots:
            todo.extend(sorted(mod.decorator_calls.get(root, ())))
        while todo:
            name = todo.pop(0)
            if name in seen or name.endswith("_plain"):
                continue
            seen.add(name)
            if name in mod.functions:
                bodies = [(name, mod.functions[name])]
            elif name in mod.classes:
                bodies = [
                    (f"{name}.{m.name}", m)
                    for m in mod.classes[name].body
                    if isinstance(m, ast.FunctionDef)
                ]
            else:
                continue
            for qual, fn in bodies:
                v = _LaunchVisitor(relpath)
                v._scope = qual.split(".")
                for stmt in fn.body:
                    v.visit(stmt)
                findings.extend(v.findings)
                todo.extend(sorted(v.calls - seen))
        # a function reached from two roots is walked once
        unique = {(f.line, f.message, f.symbol): f for f in findings}
        return sorted(unique.values(), key=lambda f: (f.line, f.message))
