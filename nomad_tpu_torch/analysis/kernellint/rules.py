"""JXL003-JXL005 — rules over the hand-written kernel fleet.

The port of ``nomad_tpu/analysis/jaxlint/rules.py``. The reference walks
the jaxpr re-traced from each kernel's recorded spec; the port has no
jaxpr, so its rules read what a kernel is given and gives back on every
call the fleet records (``backend.recording_calls``), the fleet run
twice, the build counts, and the kernel sources. Findings reuse the NTA
``lint.Finding`` shape and its line-free ratchet: ``path`` is the
kernel's wrapper module, ``symbol`` the kernel name.

- **JXL003 dtype discipline** — no 64-bit and no half dtype crosses a
  kernel's boundary: float32, int32 and bool / uint8 masks only, inputs
  and outputs of every recorded call (ROADMAP: the kernels are f32/i32).
  The bit-for-bit oracles compare uint32 views of 32-bit buffers.
- **JXL004 determinism** — the fleet run twice gives outputs equal as
  uint32 views, call for call; and no kernel source accumulates floats
  with atomics: a scan of ``csrc/*.cu`` for a float ``atomicAdd`` (or
  another float atomic, or an ``atomicCAS`` loop over float bits) and of
  the Triton body for any ``tl.atomic_*`` (ROADMAP: float reductions use
  no atomics — their order, and so their rounding, is the scheduler's).
- **JXL005 build hazards** — a registered kernel with no declared
  ``build_budget`` (the budget checker, ``analysis/retrace.py``, cannot
  audit it), one the fleet never called, and a fleet run whose second
  pass starts any build (a wrapper that compiles afresh for what should
  hit its cache).

JXL001 (host callbacks) and JXL002 (host constants baked into the
program) have no counterpart: a hand-written kernel has no callback
primitive, and its constants are in the source the fingerprint hashes.
NTA002 covers host syncs at the launch.
"""

from __future__ import annotations

import re
from pathlib import Path

from ..lint import Finding

#: dtypes that may cross a kernel's boundary
ALLOWED_DTYPES = frozenset({"float32", "int32", "bool", "uint8"})

_FLOAT_TYPES = r"(?:float|double|__half|half|__nv_bfloat16|float2|float4)"
_DECL_RE = re.compile(
    rf"\b{_FLOAT_TYPES}\b\s*(?:const\s*)?\*?\s*(?:__restrict__\s*)?(\w+)"
)
_ATOMIC_RE = re.compile(r"\batomic(Add|Sub|Max|Min|Exch|CAS)\s*\(")
_BITCAST_RE = re.compile(r"__(?:float_as_u?int|int_as_float|uint_as_float)\b")
_TRITON_ATOMIC_RE = re.compile(r"\btl\.atomic_\w+\s*\(")
_IDENT_RE = re.compile(r"[A-Za-z_]\w*")
_CHAIN_RE = re.compile(r"[A-Za-z_]\w*(?:\s*(?:\.|->)\s*[A-Za-z_]\w*)*")
_CAST_RE = re.compile(r"(?:\w+_cast\s*<[^>]*>|\(\s*[\w\s]+\*+\s*\))")


def kernel_path(entry) -> str:
    """Repo-relative path of the kernel's wrapper module."""
    return entry.module.replace(".", "/") + ".py"


def kernel_line(entry) -> int:
    try:
        return entry.wrappers[0].__wrapped__.__code__.co_firstlineno
    except AttributeError:
        return 0


def _finding(entry, rule: str, message: str) -> Finding:
    return Finding(
        rule=rule,
        path=kernel_path(entry),
        line=kernel_line(entry),
        symbol=entry.name,
        message=message,
    )


def _dtype(x) -> str | None:
    dt = getattr(x, "dtype", None)
    if dt is None or not hasattr(x, "shape"):
        return None
    return str(dt).replace("torch.", "")


def iter_tensors(x, where: str):
    """(where, dtype) of every tensor in a value: a tensor, a mesh
    carrier, or a tuple / list / dict of them."""
    dt = _dtype(x)
    if dt is not None:
        yield where, dt
    elif isinstance(x, (tuple, list)):
        for i, v in enumerate(x):
            yield from iter_tensors(v, f"{where}[{i}]")
    elif isinstance(x, dict):
        for k, v in x.items():
            yield from iter_tensors(v, f"{where}.{k}")


# -- call-level rules ---------------------------------------------------------


def check_dtype_discipline(entry, calls) -> list[Finding]:
    """JXL003 over the kernel's recorded calls."""
    out = []
    seen = set()
    for call in calls:
        values = [(f"input {i}", a) for i, a in enumerate(call.args)]
        values += [(f"input {k}", v) for k, v in call.kwargs.items()]
        values.append(("output", call.out))
        for label, value in values:
            for where, dt in iter_tensors(value, label):
                if dt in ALLOWED_DTYPES or (where, dt) in seen:
                    continue
                seen.add((where, dt))
                out.append(_finding(
                    entry, "JXL003",
                    f"{dt} at the kernel's boundary ({where}): only float32, "
                    "int32 and bool/uint8 masks cross it — pin the dtype in "
                    "the wrapper",
                ))
    return out


def _bits(x):
    """A tensor's bytes as uint32 (or uint8 when narrower) on the host."""
    import torch

    t = x.gather() if hasattr(x, "gather") and not isinstance(x, torch.Tensor) else x
    t = t.detach().contiguous().cpu()
    if t.element_size() == 4:
        return t.view(torch.int32)
    return t.view(torch.uint8) if t.dtype != torch.bool else t.to(torch.uint8)


def outputs_equal(a, b) -> bool:
    """Two outputs equal bit for bit (floats as uint32 views)."""
    import torch

    ta, tb = list(iter_values(a)), list(iter_values(b))
    if len(ta) != len(tb):
        return False
    for x, y in zip(ta, tb):
        if isinstance(x, torch.Tensor) or _dtype(x) is not None:
            if _dtype(y) is None or tuple(x.shape) != tuple(y.shape) or _dtype(x) != _dtype(y):
                return False
            if not torch.equal(_bits(x), _bits(y)):
                return False
        elif x != y:
            return False
    return True


def iter_values(x):
    if isinstance(x, (tuple, list)):
        for v in x:
            yield from iter_values(v)
    else:
        yield x


def check_determinism(entry, calls_a, calls_b) -> list[Finding]:
    """JXL004, run half: the fleet's two runs, call for call."""
    if len(calls_a) != len(calls_b):
        return [_finding(
            entry, "JXL004",
            f"the fleet's two runs called the kernel {len(calls_a)} and "
            f"{len(calls_b)} times: its calls depend on more than the inputs",
        )]
    for i, (a, b) in enumerate(zip(calls_a, calls_b)):
        if not outputs_equal(a.out, b.out):
            return [_finding(
                entry, "JXL004",
                f"outputs of call {i} differ between two runs of the fleet "
                "on the same inputs (compared as uint32 views): the kernel "
                "is not bitwise reproducible",
            )]
    return []


# -- source-level rules -------------------------------------------------------


def _first_argument(text: str, start: int) -> str:
    depth, i = 0, start
    while i < len(text):
        c = text[i]
        if c in "([{":
            depth += 1
        elif c in ")]}":
            if depth == 0:
                break
            depth -= 1
        elif c == "," and depth == 0:
            break
        i += 1
    return text[start:i]


def _call_text(text: str, start: int) -> str:
    depth, i = 1, start
    while i < len(text) and depth:
        depth += {"(": 1, ")": -1}.get(text[i], 0)
        i += 1
    return text[start:i - 1]


def _strip_comments(text: str) -> str:
    text = re.sub(r"/\*.*?\*/", lambda m: "\n" * m.group(0).count("\n"), text, flags=re.S)
    return re.sub(r"//[^\n]*", "", text)


def scan_float_atomics(text: str) -> list[tuple[int, str]]:
    """(line, message) of every float atomic in a CUDA source: an atomic
    whose target is declared with a float type in the file, and an
    ``atomicCAS`` over float bits (the CAS-loop float add)."""
    code = _strip_comments(text)
    floats = set(_DECL_RE.findall(code))
    out = []
    for m in _ATOMIC_RE.finditer(code):
        line = code.count("\n", 0, m.start()) + 1
        op = f"atomic{m.group(1)}"
        target = _CAST_RE.sub("", _first_argument(code, m.end())).strip()
        chain = _CHAIN_RE.match(target.lstrip("&( \t\n"))
        # the target's base: the last member of its leading a.b->c chain
        base = _IDENT_RE.findall(chain.group(0))[-1] if chain else None
        if base in floats:
            out.append((line, f"float {op} on '{base}'"))
        elif op == "atomicCAS" and _BITCAST_RE.search(_call_text(code, m.end())):
            out.append((line, "atomicCAS loop over float bits"))
    return out


def scan_triton_atomics(source: str) -> list[tuple[int, str]]:
    out = []
    for m in _TRITON_ATOMIC_RE.finditer(source):
        line = source.count("\n", 0, m.start()) + 1
        out.append((line, f"{m.group(0).rstrip('( ')} in the Triton body"))
    return out


def check_source_determinism(entry, csrc: Path | None = None) -> list[Finding]:
    """JXL004, source half, for one kernel's device code."""
    if entry.library is None:
        from .fingerprint import triton_source

        hits = scan_triton_atomics(triton_source())
        where = "device/score_triton.py _score_matrix_body"
    else:
        from ... import backend

        src = (backend.CSRC_DIR if csrc is None else csrc) / f"{entry.library}.cu"
        hits = scan_float_atomics(src.read_text(encoding="utf-8"))
        where = f"csrc/{entry.library}.cu"
    return [
        _finding(
            entry, "JXL004",
            f"{what} ({where}:{line}): float accumulation order under "
            "atomics is the scheduler's — reduce in a fixed order",
        )
        for line, what in hits
    ]


# -- registry-level rules ---------------------------------------------------------


def check_build_hazards(entry, calls, second_pass_builds: int) -> list[Finding]:
    """JXL005 — the budget declaration, the fleet's coverage and the
    second pass's builds."""
    out = []
    if entry.build_budget is None:
        out.append(_finding(
            entry, "JXL005",
            "no build_budget declared: the build budget checker "
            "(analysis.retrace) cannot audit this kernel — declare one",
        ))
    if not calls:
        out.append(_finding(
            entry, "JXL005",
            "kernel registered but never called: no recorded call to "
            "analyze — add it to the exercise workload",
        ))
    if second_pass_builds > 0:
        out.append(_finding(
            entry, "JXL005",
            f"the fleet's second pass started {second_pass_builds} build(s): "
            "the wrapper compiles afresh for calls its cache should hit",
        ))
    return out


def check_kernel(entry, calls_a, calls_b, second_pass_builds: int) -> list[Finding]:
    """All JXL findings for one kernel."""
    findings: list[Finding] = []
    findings.extend(check_dtype_discipline(entry, calls_a + calls_b))
    findings.extend(check_determinism(entry, calls_a, calls_b))
    findings.extend(check_source_determinism(entry))
    findings.extend(check_build_hazards(entry, calls_a, second_pass_builds))
    findings.sort(key=lambda f: (f.rule, f.message))
    return findings
