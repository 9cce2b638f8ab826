"""NTA009 — no unbounded blocking primitives in server/rpc code.

A ``thread.join()`` with no timeout or a ``queue.get()`` with no timeout
turns a wedged peer into a wedged *server*: the shutdown path stalls
behind a worker stuck in a C call, an RPC reader blocks forever on a
half-closed socket, and the process survives SIGTERM only via SIGKILL —
losing the flight recorder and any in-flight acks. Every join/get in
these modules must carry a ``timeout=`` (and re-check its exit
condition in a loop if it needs to wait longer).

Flagged:
- ``<x>.join()`` with no ``timeout`` argument, and
- ``<x>.get()`` with no ``timeout`` argument — unless ``block`` is the
  constant ``False`` (non-blocking get never hangs).

``str.join(iterable)`` is not a hazard; calls with positional arguments
are skipped so only the zero-arg thread/process join shape is flagged.

Scope: ``nomad_tpu_torch/server/``, ``nomad_tpu_torch/rpc/``.
"""

from __future__ import annotations

import ast

from ..lint import Finding, Rule, ScopedVisitor


def _kw(node: ast.Call, name: str) -> ast.keyword | None:
    for kw in node.keywords:
        if kw.arg == name:
            return kw
    return None


class _Visitor(ScopedVisitor):
    def visit_Call(self, node: ast.Call) -> None:
        if isinstance(node.func, ast.Attribute):
            attr = node.func.attr
            if attr == "join" and not node.args and _kw(node, "timeout") is None:
                self.add(
                    "NTA009",
                    node,
                    "unbounded .join(): pass timeout= and re-check "
                    "is_alive() in a loop (a wedged thread must not "
                    "wedge shutdown)",
                )
            elif attr == "get" and not node.args and _kw(node, "timeout") is None:
                block = _kw(node, "block")
                nonblocking = (
                    block is not None
                    and isinstance(block.value, ast.Constant)
                    and block.value.value is False
                )
                if not nonblocking:
                    self.add(
                        "NTA009",
                        node,
                        "unbounded queue.get(): pass timeout= (or "
                        "block=False) so a dead producer cannot hang "
                        "the consumer forever",
                    )
        self.generic_visit(node)


class BlockingWithoutTimeout(Rule):
    id = "NTA009"
    title = "no unbounded join()/queue.get() in server/rpc"

    def applies_to(self, relpath: str) -> bool:
        return relpath.startswith("nomad_tpu_torch/server/") or relpath.startswith(
            "nomad_tpu_torch/rpc/"
        )

    def check(self, tree, source, relpath) -> list[Finding]:
        v = _Visitor(relpath)
        v.visit(tree)
        return v.findings
