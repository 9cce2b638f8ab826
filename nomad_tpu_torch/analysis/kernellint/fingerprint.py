"""Kernel fingerprints: the counterpart of the reference's JXL006.

The reference hashes a canonical rendering of each traced jaxpr. The
port's device programs are source files, so a fingerprint is built from
what the build reads, and can be made on a host with neither ``nvcc``
nor ``triton``:

- a CUDA kernel: the library hash ``backend.library_hash`` gives its
  build (the ``.cu`` file, every shared ``*.cuh``, ``NVCC_FLAGS``) plus
  the exported symbol it launches, one config a symbol;
- the Triton kernel: ``_score_matrix_body``'s source, ``BLOCK_N``,
  ``NUM_WARPS`` and ``ENABLE_FP_FUSION``, plus each specialization key
  this process launched (one config a key; ``source`` alone before any
  launch).

Any edit to what is compiled changes the fingerprint; nothing else
does: the hash reads no path, address or clock, so two processes agree.
"""

from __future__ import annotations

import hashlib
import inspect
from pathlib import Path


def _digest(*parts) -> str:
    h = hashlib.sha256()
    for p in parts:
        h.update(str(p).encode("utf-8") + b"\0")
    return h.hexdigest()[:16]


def cuda_fingerprint(library: str, symbol: str, csrc: Path | None = None) -> str:
    """16 hex digits: ``csrc/<library>.cu``'s build hash and the symbol."""
    from ... import backend

    return _digest("cuda", backend.library_hash(library, csrc), symbol)


def triton_source() -> str:
    from ...device import score_triton

    return inspect.getsource(score_triton._score_matrix_body)


def triton_fingerprint(key=None, source: str | None = None) -> str:
    """16 hex digits: the score-matrix body, its launch constants and
    (when given) one specialization key."""
    from ...device import score_triton as st

    body = triton_source() if source is None else source
    return _digest(
        "triton", body, st.BLOCK_N, st.NUM_WARPS, st.ENABLE_FP_FUSION,
        "" if key is None else specialization_label(key),
    )


def specialization_label(key) -> str:
    spread, tp, n16, n1 = key
    return (
        f"algorithm_spread={spread}, throughputs={'given' if tp else 'None'}, "
        f"n%16==0={n16}, n==1={n1}"
    )


def kernel_configs(entry, csrc: Path | None = None) -> dict:
    """{config label: fingerprint} of one registered kernel."""
    if entry.library is None:
        from ...device import score_triton

        keys = score_triton.launched_specializations()
        if not keys:
            return {"source": triton_fingerprint()}
        return {specialization_label(k): triton_fingerprint(k) for k in keys}
    return {
        f"{entry.library}.cu:{sym}": cuda_fingerprint(entry.library, sym, csrc)
        for sym in entry.symbols
    }


def call_configs(entry, call) -> list[str]:
    """The config labels one recorded call ran under: its specialization
    key for the Triton kernel (read from its arguments), every symbol of
    its library for a CUDA kernel (which of them a call launches is the
    wrapper's choice by shape)."""
    if entry.library is None:
        from ...device import score_triton

        args, kw = call.args, call.kwargs
        capacity = args[0] if args else kw["capacity"]
        spread = args[10] if len(args) > 10 else kw["algorithm_spread"]
        tp = args[11] if len(args) > 11 else kw.get("throughputs")
        key = score_triton.specialization_key(spread, tp is not None, capacity.shape[0])
        return [specialization_label(key)]
    return [f"{entry.library}.cu:{sym}" for sym in entry.symbols]


def fingerprint_table(launched_only: bool = False, csrc: Path | None = None) -> dict:
    """{kernel name: {config label: fingerprint}} for every kernel of the
    fleet (``launched_only``: every kernel a call of which has returned
    in this process; ``csrc`` another tree's sources). ``/v1/agent/trace``
    embeds it, so two builds' device code is diffable from their
    surfaces."""
    from .registry import import_fleet, production_kernels

    out: dict = {}
    for name, entry in sorted(production_kernels(import_fleet()).items()):
        if launched_only and not entry.called:
            continue
        out[name] = kernel_configs(entry, csrc)
    return out
