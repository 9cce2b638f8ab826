"""InlineRaft — the single-server raft seam.

The dev-agent path (reference: a single-server Raft cluster that elects
itself instantly; nomad agent -dev). Writes are serialized, optionally
made durable in the native WAL, and applied to the FSM immediately. On
boot, the newest snapshot is restored and the log suffix replayed —
checkpoint/resume for the whole control plane (fsm.go Snapshot/Restore).
"""

from __future__ import annotations

import os
import pickle
import threading
from typing import Any, Optional, Tuple

SNAP_EVERY_ENTRIES = 4096  # log entries between automatic snapshots


class InlineRaft:
    def __init__(self, fsm, data_dir: Optional[str] = None,
                 snapshot_fn=None, restore_fn=None):
        """``snapshot_fn(path) -> index`` / ``restore_fn(path) -> store``
        hook the state-store snapshot machinery (state/snapshot.py)."""
        self.fsm = fsm
        self.data_dir = data_dir
        self.snapshot_fn = snapshot_fn
        self.restore_fn = restore_fn
        self._lock = threading.Lock()
        self._wal = None
        self._applied_since_snap = 0
        if data_dir:
            from ..native import WalStore

            os.makedirs(data_dir, exist_ok=True)
            self._wal = WalStore(os.path.join(data_dir, "raft"))

    # -- contract ----------------------------------------------------------
    def is_leader(self) -> bool:
        return True

    def leader_id(self) -> Optional[str]:
        return "local"

    def peers(self) -> dict:
        return {"local": "local"}

    def remove_peer(self, node_id: str, timeout: float = 10.0) -> None:
        raise ValueError("single-server (dev) mode has no removable peers")

    def apply(self, mtype: int, payload: Optional[dict] = None,
              timeout: float = 10.0) -> Tuple[int, Any]:
        from ..chaos.plane import chaos_site, make_fault

        # consulted before the entry is assigned an index: a "drop"
        # rejects the write to the caller (a lost raft commit, like a
        # leadership change mid-apply) — nothing is applied, nothing is
        # durable, and the caller's retry path must cope
        if chaos_site("fsm.apply") == "drop":
            raise make_fault("fsm.apply")
        with self._lock:
            index = self.fsm.store.latest_index + 1
            if self._wal is not None:
                self._wal.append(
                    index, term=1, type_=int(mtype),
                    data=pickle.dumps(payload, pickle.HIGHEST_PROTOCOL),
                )
                # Durable-dev-agent contract: the write is acked to the
                # caller, so it must survive power loss, not just
                # crash-stop. fsync per apply (group-committed under the
                # serializing lock).
                self._wal.sync()
            result = self.fsm.apply(index, mtype, payload)
            if self._wal is not None:
                self._applied_since_snap += 1
                if (
                    self.snapshot_fn is not None
                    and self._applied_since_snap >= SNAP_EVERY_ENTRIES
                ):
                    self._snapshot_locked()
            return index, result

    def barrier(self, timeout: float = 10.0) -> int:
        from ..server.fsm import MsgType

        index, _ = self.apply(MsgType.NOOP, None, timeout=timeout)
        return index

    # -- durability --------------------------------------------------------
    def _snap_path(self) -> str:
        return os.path.join(self.data_dir, "state.snap")

    def _snapshot_locked(self) -> None:
        index = self.snapshot_fn(self._snap_path())
        self._wal.compact_prefix(index)
        self._wal.sync()
        self._applied_since_snap = 0

    def snapshot(self) -> int:
        """Explicit checkpoint (operator snapshot save)."""
        with self._lock:
            if self._wal is None or self.snapshot_fn is None:
                raise RuntimeError("snapshots require a data_dir")
            self._snapshot_locked()
            return self._wal.last_index() or self.fsm.store.latest_index

    def restore(self) -> bool:
        """Boot-time recovery: restore snapshot (if any), replay the log
        suffix. Returns True when any durable state was recovered."""
        if self._wal is None:
            return False
        recovered = False
        if self.restore_fn is not None and os.path.exists(self._snap_path()):
            self.restore_fn(self._snap_path())
            recovered = True
        first, last = self._wal.first_index(), self._wal.last_index()
        start = max(first, self.fsm.store.latest_index + 1)
        for index in range(start, last + 1):
            _term, mtype, data = self._wal.get(index)
            self.fsm.apply(index, mtype, pickle.loads(data))
            recovered = True
        return recovered

    def sync(self) -> None:
        if self._wal is not None:
            self._wal.sync()

    def close(self) -> None:
        if self._wal is not None:
            self._wal.sync()
            self._wal.close()
            self._wal = None

    def stats(self) -> dict:
        return {
            "state": "Leader",
            "term": 1,
            "last_log_index": (
                self._wal.last_index() if self._wal else self.fsm.store.latest_index
            ),
            "commit_index": self.fsm.store.latest_index,
            "num_peers": 0,
        }
