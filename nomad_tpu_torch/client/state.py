"""Client local state — restore-on-restart of alloc/task state.

Reference: client/state/ (StateDB over BoltDB via helper/boltdd): the
client persists each alloc it is running plus per-task driver handles, so
a restarted client re-attaches to live tasks instead of killing them
(client restore path client/client.go + task_runner.go:488-519).

Here the store is the native WAL's durable KV (nomad_tpu_torch.native) — the
same BoltDB role it plays for the server's term/vote. The live view is a
pair of in-memory maps of pre-pickled records (alloc id → bytes,
(alloc id, task) → bytes) flushed as one atomic whole-file write per
mutation — matching the KV backend's whole-file atomicity; per-record
bolt buckets would add no durability granularity here.
"""

from __future__ import annotations

import os
import pickle
import threading
from typing import Dict, Optional

from ..native import WalStore


class ClientStateDB:
    def __init__(self, data_dir: str):
        os.makedirs(data_dir, exist_ok=True)
        self._wal = WalStore(os.path.join(data_dir, "client-state"))
        self._lock = threading.Lock()
        self._closed = False
        # the KV is whole-file persisted; maintain the live view in memory
        self._allocs: Dict[str, bytes] = {}
        self._handles: Dict[tuple, bytes] = {}
        self._load()

    def _load(self) -> None:
        raw = self._wal.kv_get("state")
        if not raw:
            return
        try:
            data = pickle.loads(raw)
        except Exception:
            return
        self._allocs = data.get("allocs", {})
        self._handles = data.get("handles", {})

    def _flush(self) -> None:
        if self._closed:
            # shutdown raced a still-running task thread's final status
            # write; the restart reconciles against server state anyway
            return
        self._wal.kv_set(
            "state",
            pickle.dumps(
                {"allocs": self._allocs, "handles": self._handles},
                pickle.HIGHEST_PROTOCOL,
            ),
        )

    # -- allocs ------------------------------------------------------------
    def put_alloc(self, alloc) -> None:
        with self._lock:
            self._allocs[alloc.id] = pickle.dumps(
                alloc, pickle.HIGHEST_PROTOCOL
            )
            self._flush()

    def delete_alloc(self, alloc_id: str) -> None:
        with self._lock:
            self._allocs.pop(alloc_id, None)
            for key in [k for k in self._handles if k[0] == alloc_id]:
                self._handles.pop(key, None)
            self._flush()

    def allocs(self) -> list:
        with self._lock:
            out = []
            for raw in self._allocs.values():
                try:
                    out.append(pickle.loads(raw))
                except Exception:
                    continue
            return out

    # -- task handles ------------------------------------------------------
    def put_handle(self, alloc_id: str, task_name: str, handle) -> None:
        with self._lock:
            self._handles[(alloc_id, task_name)] = pickle.dumps(
                handle, pickle.HIGHEST_PROTOCOL
            )
            self._flush()

    def handles_for(self, alloc_id: str) -> Dict[str, object]:
        with self._lock:
            out = {}
            for (aid, name), raw in self._handles.items():
                if aid != alloc_id:
                    continue
                try:
                    out[name] = pickle.loads(raw)
                except Exception:
                    continue
            return out

    def close(self) -> None:
        with self._lock:
            if self._closed:
                return
            self._closed = True
            self._wal.sync()
            self._wal.close()
