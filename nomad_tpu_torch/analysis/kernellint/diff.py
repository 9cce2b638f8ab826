"""The invariance differ: the port of ``nomad_tpu/analysis/jaxlint/diff.py``.

The perf story leans on claims that a feature does not change what runs
on the device: placement explainability (``explain=`` is host-side
provenance, never another kernel), incremental rescoring (the resident
``used`` tensor feeds the same kernels as a fresh upload) and the mesh.
The reference proves them fleet-wide as jaxpr fingerprint equalities.
The port's kernels are built from source, so each prover runs the
placement exercise with the feature off and on, records every kernel
call, and compares the set of (kernel, config, fingerprint) launched on
each side (``fingerprint.call_configs``), with the builds the "on" side
started:

- explain and incremental on/off: the same set, no build;
- mesh on/off: the "on" side adds exactly ``closed_form_topk_merge``
  and nothing else, no build. In the reference the mesh leaves every
  jaxpr as it is; in the port the cross-shard merge is the mesh's own
  kernel.

Each prover restores the ambient state it touched (the variables, the
resolved mesh and incremental decisions) and returns a report dict
rather than asserting, so the CLI can print it and tests can pin it.
"""

from __future__ import annotations

import contextlib
import os

_MESH_ENV = "NOMAD_TPU_MESH"
_INCR_ENV = "NOMAD_TPU_INCREMENTAL"
MERGE = "closed_form_topk_merge"


def _launched(calls) -> set:
    from .fingerprint import call_configs, kernel_configs
    from .registry import import_fleet

    reg = import_fleet()
    out = set()
    for c in calls:
        entry = reg[c.name]
        fps = kernel_configs(entry)
        for label in call_configs(entry, c):
            out.add((c.name, label, fps.get(label, "")))
    return out


def _run(fn) -> tuple[set, int]:
    """(launched set, builds started) of one exercise run."""
    from ... import backend
    from .. import retrace

    before = sum(retrace.counts().values())
    with backend.recording_calls() as calls:
        fn()
    return _launched(calls), sum(retrace.counts().values()) - before


@contextlib.contextmanager
def _env(name: str, value):
    prev = os.environ.get(name)
    try:
        if value is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = value
        yield
    finally:
        if prev is None:
            os.environ.pop(name, None)
        else:
            os.environ[name] = prev


def _report(claim, off, on, builds, expect_added=frozenset()) -> dict:
    added = sorted(on - off)
    removed = sorted(off - on)
    added_kernels = {k for k, _, _ in added}
    ok = not removed and added_kernels == set(expect_added) and builds == 0
    return {
        "claim": claim,
        "ok": ok,
        "added": [list(x) for x in added],
        "removed": [list(x) for x in removed],
        "added_builds": builds,
        "kernels": sorted({k for k, _, _ in on | off}),
    }


def prove_explain_invariance(device="cuda") -> dict:
    """Run the placement exercise with ``explain=False`` then
    ``explain=True`` and prove the explain path launched no other kernel
    and started no build."""
    from ... import backend
    from .exercise import run_placement_paths

    dev = backend.resolve_device(device)
    with _env(_MESH_ENV, "off"):
        backend.reset_mesh()
        try:
            off, _ = _run(lambda: run_placement_paths(dev, explain=False))
            on, builds = _run(lambda: run_placement_paths(dev, explain=True))
        finally:
            backend.reset_mesh()
    return _report("explain-on/off launches the same kernels", off, on, builds)


def prove_incremental_invariance(device="cuda") -> dict:
    """Run the placement exercise with the incremental score cache off,
    then on (two passes: full rebuild + one dirty-row patch with a
    generation swap between), and prove the incremental path launched no
    other kernel and started no build: the cached device tensor feeds
    the kernels with the shape and dtype of a fresh upload."""
    from ... import backend
    from .exercise import run_placement_paths

    dev = backend.resolve_device(device)
    with _env(_MESH_ENV, "off"):
        backend.reset_mesh()
        try:
            with _env(_INCR_ENV, "off"):
                backend.reset_incremental()
                off, _ = _run(lambda: run_placement_paths(dev, incremental=False))
            with _env(_INCR_ENV, "on"):
                backend.reset_incremental()
                on, builds = _run(lambda: run_placement_paths(dev, incremental=True))
        finally:
            backend.reset_incremental()
            backend.reset_mesh()
    return _report("incremental-on/off launches the same kernels", off, on, builds)


def prove_mesh_invariance(device="cuda") -> dict:
    """Run the placement exercise with the mesh off, then under a 1x2
    node-axis mesh (both cells on ``device``), and prove the mesh adds
    exactly the cross-shard merge: every kernel launched without it is
    launched with it under the same fingerprint, and no build starts."""
    from ... import backend
    from .exercise import MESH_SHAPE, run_placement_paths

    dev = backend.resolve_device(device)
    with _env(_MESH_ENV, "off"):
        backend.reset_mesh()
        try:
            off, _ = _run(lambda: run_placement_paths(dev))
            mesh = backend.make_mesh(*MESH_SHAPE, devices=dev)
            on, builds = _run(lambda: run_placement_paths(dev, mesh=mesh))
        finally:
            backend.reset_mesh()
    rep = _report(
        "mesh-on/off adds exactly the cross-shard merge", off, on, builds,
        expect_added={MERGE},
    )
    rep["mesh_shape"] = list(MESH_SHAPE)
    return rep


def prove_all(device="cuda") -> dict:
    """All fleet invariants; ``ok`` is the conjunction."""
    explain = prove_explain_invariance(device)
    incremental = prove_incremental_invariance(device)
    mesh = prove_mesh_invariance(device)
    return {
        "ok": explain["ok"] and incremental["ok"] and mesh["ok"],
        "explain": explain,
        "incremental": incremental,
        "mesh": mesh,
    }
