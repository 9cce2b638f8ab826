"""Volume watcher — releases CSI volume claims as their claiming
allocations become terminal.

Reference: nomad/volumewatcher/ (volumes_watcher.go:183 spawns one watcher
per claimed volume; volume_watcher.go:257 walks claims, issues unpublish
RPCs, and removes released claims). Without real CSI node/controller
plugins the unpublish step is bookkeeping: drop the claim so the volume
becomes claimable by the next placement (the scheduling-visible effect).
"""

from __future__ import annotations

import threading

from .fsm import MsgType
from typing import Optional


class VolumeWatcher:
    def __init__(self, server, interval: float = 0.25):
        self.server = server
        self.interval = interval
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._run, name="volume-watcher", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)

    def _run(self) -> None:
        while not self._stop.wait(self.interval):
            try:
                self.tick()
            except Exception:  # noqa: BLE001 — watcher must survive
                import logging

                logging.getLogger(__name__).exception("volume watcher tick")

    def tick(self) -> int:
        """One pass: release claims whose alloc is gone or terminal.
        Returns the number of claims released."""
        store = self.server.store
        released = 0
        for vol in list(store.csi_volumes()):
            for alloc_id in list(vol.read_claims) + list(vol.write_claims):
                if alloc_id in vol.external_claims:
                    continue  # released only by an explicit Unpublish/API call
                alloc = store.alloc_by_id(alloc_id)
                if alloc is None or alloc.terminal_status():
                    _i, ok = self.server.raft_apply(
                        MsgType.CSI_RELEASE,
                        {"volume_id": vol.id, "claim_id": alloc_id},
                    )
                    if ok:
                        released += 1
        return released
