"""NTA017 — kernels are built and loaded only through the seam.

The port of ``nomad_tpu/analysis/rules/kernelseam.py``. The reference
flags a bare ``jax.jit`` outside ``utils/backend.py``'s ``traced_jit``.
The port's kernels are hand-written: ``backend.py`` builds a CUDA
source with ``nvcc`` and loads it (``build_all``, ``cuda_library``),
hashing the source, the headers it includes and the flags into the
library's name, and counting the load as a build (``note_compile``) that
the kernel guard's watchdog and the build budgets
(``analysis/retrace.py``) read; ``device/score_triton.py`` JIT-wraps the
one Triton kernel in ``_build``. A library loaded or a kernel compiled
anywhere else is invisible to all of that: it is not in ``nomad-tpu
analyze kernels``' fingerprint table, its builds pass no budget, and a
stale build can load after its source changed.

Flagged, anywhere in ``nomad_tpu_torch/``: ``ctypes.CDLL`` (and
``cdll.LoadLibrary``), ``torch.utils.cpp_extension`` (``load``,
``load_inline``), ``triton.jit`` (and ``from triton import jit``), a
``subprocess`` call whose arguments name ``nvcc``, and a
``cuda_library(...)`` call outside the six kernel modules.

Exempt: ``backend.py`` (the seam itself), ``_build`` in
``device/score_triton.py`` (the Triton kernel's one build site), and
``native/wal.py``, which loads the write-ahead log's host library (C++
built with ``g++``, no device code).
"""

from __future__ import annotations

import ast

from ..lint import Finding, Rule, ScopedVisitor, dotted_name

_SCOPES = ("nomad_tpu_torch/",)
_EXEMPT = (
    "nomad_tpu_torch/backend.py",
    "nomad_tpu_torch/native/wal.py",
)
# (module, function): the Triton kernel's one build site
_EXEMPT_SYMBOLS = (("nomad_tpu_torch/device/score_triton.py", "_build"),)
_KERNEL_MODULES = (
    "nomad_tpu_torch/device/score.py",
    "nomad_tpu_torch/device/score_triton.py",
    "nomad_tpu_torch/device/preempt.py",
    "nomad_tpu_torch/device/cp.py",
    "nomad_tpu_torch/device/migrate.py",
    "nomad_tpu_torch/scheduler/hetero.py",
)
_SUBPROCESS = {
    "subprocess.run", "subprocess.Popen", "subprocess.call",
    "subprocess.check_call", "subprocess.check_output",
}

_MSG = (
    "build and load kernels through backend.py (cuda_library / build_all) "
    "so the build is hashed, counted against its budget, and visible to "
    "the kernel lint"
)


def _names_nvcc(node: ast.AST) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Constant) and isinstance(sub.value, str) and "nvcc" in sub.value:
            return True
        if isinstance(sub, ast.Call) and (dotted_name(sub.func) or "").endswith("nvcc_path"):
            return True
    return False


class _SeamVisitor(ScopedVisitor):
    def __init__(self, relpath: str, kernel_module: bool):
        super().__init__(relpath)
        self.kernel_module = kernel_module

    def visit_Attribute(self, node: ast.Attribute) -> None:
        name = dotted_name(node) or ""
        if name in ("ctypes.CDLL", "ctypes.cdll.LoadLibrary", "cdll.LoadLibrary"):
            self.add("NTA017", node, f"bare library load {name}: {_MSG}")
            return
        if name == "torch.utils.cpp_extension" or name.startswith("cpp_extension.load"):
            self.add("NTA017", node, f"torch.utils.cpp_extension build: {_MSG}")
            return
        if name == "triton.jit":
            self.add("NTA017", node, f"bare triton.jit: {_MSG}")
            return
        self.generic_visit(node)

    def visit_ImportFrom(self, node: ast.ImportFrom) -> None:
        module = node.module or ""
        names = {a.name for a in node.names}
        if module == "triton" and "jit" in names:
            self.add("NTA017", node, f"from triton import jit: {_MSG}")
        if module == "ctypes" and "CDLL" in names:
            self.add("NTA017", node, f"from ctypes import CDLL: {_MSG}")
        if module.startswith("torch.utils.cpp_extension") or (
            module == "torch.utils" and "cpp_extension" in names
        ):
            self.add("NTA017", node, f"torch.utils.cpp_extension import: {_MSG}")

    def visit_Call(self, node: ast.Call) -> None:
        name = dotted_name(node.func) or ""
        if name in _SUBPROCESS and _names_nvcc(node):
            self.add("NTA017", node, f"nvcc run outside the seam: {_MSG}")
        if name.rsplit(".", 1)[-1] == "cuda_library" and not self.kernel_module:
            self.add(
                "NTA017", node,
                "cuda_library(...) outside the kernel modules: launch the "
                "kernel through its module's guarded wrapper",
            )
        self.generic_visit(node)


class KernelSeamDiscipline(Rule):
    id = "NTA017"
    title = "kernels are built and loaded only through the seam"

    def applies_to(self, relpath: str) -> bool:
        if relpath in _EXEMPT:
            return False
        return relpath.startswith(_SCOPES)

    def check(self, tree, source, relpath) -> list[Finding]:
        v = _SeamVisitor(relpath, relpath in _KERNEL_MODULES)
        v.visit(tree)
        return [
            f for f in v.findings
            if (f.path, f.symbol.split(".")[0]) not in _EXEMPT_SYMBOLS
        ]
