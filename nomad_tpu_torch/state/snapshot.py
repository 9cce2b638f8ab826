"""State snapshot persistence — checkpoint/resume of the whole cluster
state.

Reference: nomadFSM.Snapshot/Restore with 21 typed record streams
(nomad/fsm.go:36-59) + ``operator snapshot save/restore``
(helper/snapshot). Here the snapshot is a versioned pickle of the store's
tables (the record types are plain dataclasses); the format carries a
magic + version header so future migrations can dispatch.

``restore_snapshot`` reads through the port's restricted unpickler
(``rpc/framing.py``): a snapshot is the port's own, and a file that
names a class of another package is refused with ``FramingError``.
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


def restore_snapshot(path: str):
    """Rebuild a StateStore from a snapshot file (indexes re-derived)."""
    from .store import StateStore

    with open(path, "rb") as f:
        magic = f.read(len(SNAPSHOT_MAGIC))
        if magic != SNAPSHOT_MAGIC:
            raise ValueError(f"{path} is not a nomad-tpu snapshot")
        # snapshot blobs arrive over the wire too (Raft InstallSnapshot) —
        # deserialize through the framework allowlist, not bare pickle
        from ..rpc.framing import restricted_loads

        payload = restricted_loads(f.read())
    if payload["version"] != SNAPSHOT_VERSION:
        raise ValueError(f"unsupported snapshot version {payload['version']}")

    store = StateStore()
    index = max(payload["index"], 1)
    for node in payload["nodes"].values():
        store.upsert_node(index, node)
    # jobs: preserve versions (upsert_job would re-version)
    with store._lock:
        jobs = store._own("jobs")
        jobs.update(payload["jobs"])
        versions = store._own("job_versions")
        versions.update(payload["job_versions"])
        store._bump(index, "jobs", "job_versions")
    store.upsert_evals(index, list(payload["evals"].values()))
    store.upsert_allocs(index, list(payload["allocs"].values()))
    for d in payload["deployments"].values():
        store.upsert_deployment(index, d)
    if payload.get("acl_policies"):
        store.upsert_acl_policies(index, list(payload["acl_policies"].values()))
    if payload.get("acl_tokens"):
        store.upsert_acl_tokens(index, list(payload["acl_tokens"].values()))
    if payload.get("acl_bootstrap"):
        with store._lock:
            store._own("indexes")["acl_bootstrap"] = payload["acl_bootstrap"]
    for vol in payload.get("csi_volumes", {}).values():
        store.restore_csi_volume(vol)
    for ns in payload.get("namespaces", {}).values():
        store.restore_namespace(ns)
    if payload.get("scaling_events"):
        with store._lock:
            store._own("scaling_events").update(payload["scaling_events"])
    store.set_scheduler_config(index, payload["scheduler_config"])
    store._latest_index = max(store._latest_index, payload["index"])
    return store
