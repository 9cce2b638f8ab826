"""State snapshot persistence — checkpoint/resume of the whole cluster
state.

Reference: nomadFSM.Snapshot/Restore with 21 typed record streams
(nomad/fsm.go:36-59) + ``operator snapshot save/restore``
(helper/snapshot). Here the snapshot is a versioned pickle of the store's
tables (the record types are plain dataclasses); the format carries a
magic + version header so future migrations can dispatch.

The port writes snapshots only; restoring one is not ported yet (see
ROADMAP queue A).
"""

from __future__ import annotations

import os
import pickle

SNAPSHOT_MAGIC = b"NOMADTPU-SNAP"
SNAPSHOT_VERSION = 1


def atomic_write_bytes(path: str, data: bytes) -> None:
    """Write ``data`` to ``path`` atomically (tmp + fsync + rename + dir
    fsync): a crash mid-write leaves either the old file or the new one,
    never a torn mix."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    dirfd = os.open(os.path.dirname(os.path.abspath(path)) or ".", os.O_RDONLY)
    try:
        os.fsync(dirfd)
    finally:
        os.close(dirfd)


def save_snapshot(store, path: str) -> int:
    """Serialize a consistent snapshot; returns the index it captured."""
    snap = store.snapshot()
    payload = {
        "version": SNAPSHOT_VERSION,
        "index": snap.index,
        "nodes": dict(snap._t.nodes),
        "jobs": dict(snap._t.jobs),
        "job_versions": dict(snap._t.job_versions),
        "evals": dict(snap._t.evals),
        "allocs": dict(snap._t.allocs),
        "deployments": dict(snap._t.deployments),
        "acl_policies": dict(snap._t.acl_policies),
        "acl_tokens": dict(snap._t.acl_tokens),
        "acl_bootstrap": snap._t.indexes.get("acl_bootstrap", 0),
        "csi_volumes": dict(snap._t.csi_volumes),
        "namespaces": dict(snap._t.namespaces),
        "scaling_events": dict(snap._t.scaling_events),
        "scheduler_config": snap._t.scheduler_config,
    }
    # Atomic replace: never truncate the previous good snapshot. A crash
    # mid-write must leave either the old snapshot or the new one — the WAL
    # prefix behind the old snapshot is compacted, so a torn write here
    # would permanently lose committed state (helper/snapshot does the
    # same tmp+rename dance in the reference).
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(SNAPSHOT_MAGIC)
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)
    dirfd = os.open(os.path.dirname(os.path.abspath(path)) or ".", os.O_RDONLY)
    try:
        os.fsync(dirfd)
    finally:
        os.close(dirfd)
    return snap.index
