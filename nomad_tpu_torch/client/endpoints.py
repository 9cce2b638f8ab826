"""Client-served RPC endpoints: filesystem and log access for allocs.

Reference: client/fs_endpoint.go (FileSystem.List/Stat/Stream/Logs served
BY the client over streaming RPC; the server/HTTP agent proxies to the
node that runs the alloc, command/agent/fs_endpoint.go). The client runs a
small RPC server and advertises its address as a node attribute — the
reachability contract client/rpc.go establishes via server-mediated
connections.
"""

from __future__ import annotations

import os
import time
from typing import Iterator

from ..rpc import RPCServer

ATTR_RPC_ADDR = "nomad.client.rpc_addr"

LOG_CHUNK = 64 << 10
FOLLOW_POLL = 0.2


class ClientEndpoints:
    def __init__(self, client):
        self.client = client
        self.rpc = RPCServer()

    def start(self) -> str:
        self.rpc.start()
        self.rpc.register("FS.list", self.fs_list)
        self.rpc.register("FS.stat", self.fs_stat)
        self.rpc.register("FS.read", self.fs_read)
        self.rpc.register("FS.logs", self.fs_logs)
        return self.rpc.address

    def stop(self) -> None:
        self.rpc.stop()

    # -- helpers -----------------------------------------------------------
    def _alloc_dir(self, alloc_id: str) -> str:
        return os.path.join(self.client.data_dir, "allocs", alloc_id)

    def _resolve(self, alloc_id: str, path: str) -> str:
        """Path confined to the alloc dir (fs_endpoint.go path escaping
        guard): a crafted ../ must not escape into the client host."""
        base = os.path.realpath(self._alloc_dir(alloc_id))
        full = os.path.realpath(os.path.join(base, path.lstrip("/")))
        if full != base and not full.startswith(base + os.sep):
            raise PermissionError(f"path escapes alloc dir: {path}")
        return full

    # -- handlers ----------------------------------------------------------
    def fs_list(self, args) -> list[dict]:
        full = self._resolve(args["alloc_id"], args.get("path", "/"))
        out = []
        for name in sorted(os.listdir(full)):
            p = os.path.join(full, name)
            st = os.stat(p)
            out.append(
                {
                    "name": name,
                    "is_dir": os.path.isdir(p),
                    "size": st.st_size,
                    "mtime": st.st_mtime,
                }
            )
        return out

    def fs_stat(self, args) -> dict:
        full = self._resolve(args["alloc_id"], args.get("path", "/"))
        st = os.stat(full)
        return {
            "name": os.path.basename(full) or "/",
            "is_dir": os.path.isdir(full),
            "size": st.st_size,
            "mtime": st.st_mtime,
        }

    def fs_read(self, args) -> bytes:
        full = self._resolve(args["alloc_id"], args["path"])
        offset = int(args.get("offset", 0))
        limit = int(args.get("limit", 1 << 20))
        with open(full, "rb") as f:
            if offset < 0:  # tail semantics
                f.seek(0, os.SEEK_END)
                size = f.tell()
                f.seek(max(0, size + offset))
            else:
                f.seek(offset)
            return f.read(limit)

    def fs_logs(self, args) -> Iterator[dict]:
        """Streaming log reader; with follow=True keeps tailing until the
        connection drops (command/agent/fs_endpoint.go Logs)."""
        alloc_id = args["alloc_id"]
        task = args["task"]
        kind = args.get("type", "stdout")
        if kind not in ("stdout", "stderr"):
            raise ValueError("type must be stdout|stderr")
        path = self._resolve(alloc_id, f"{task}/{task}.{kind}")
        follow = bool(args.get("follow", False))
        offset = int(args.get("offset", 0))
        # wait briefly for the file to appear (task may be starting)
        deadline = time.time() + 5
        while not os.path.exists(path) and time.time() < deadline:
            time.sleep(0.1)
        if not os.path.exists(path):
            return
        with open(path, "rb") as f:
            if offset < 0:
                f.seek(0, os.SEEK_END)
                f.seek(max(0, f.tell() + offset))
            else:
                f.seek(offset)
            idle_rounds = 0
            while True:
                chunk = f.read(LOG_CHUNK)
                if chunk:
                    idle_rounds = 0
                    yield {
                        "offset": f.tell() - len(chunk),
                        "data": chunk.decode("utf-8", "replace"),
                    }
                    continue
                if not follow:
                    return
                # logmon copy-truncate rotation shrinks the live file
                # under us: a reader offset past the new EOF would read
                # b'' forever — rewind on truncation
                try:
                    if os.fstat(f.fileno()).st_size < f.tell():
                        f.seek(0)
                        continue
                except OSError:
                    return
                # stop following once the task is dead and drained
                runner = self.client.runners.get(alloc_id)
                tr = runner.task_runners.get(task) if runner else None
                if tr is None or tr.state.state == "dead":
                    idle_rounds += 1
                    if idle_rounds > 3:
                        return
                time.sleep(FOLLOW_POLL)
