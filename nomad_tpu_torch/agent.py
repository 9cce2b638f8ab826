"""Agent — the single-binary composition of server and/or client.

Reference: command/agent/agent.go (:709 setupServer, :884 setupClient);
``nomad agent -dev`` runs both in one process with an in-process RPC link,
which is exactly what DevAgent does here.

The port's agent runs its server's kernels on ``device`` (default
``"cuda"``, which raises where CUDA is absent; ``"cpu"`` runs the plain
versions), like every entry point of the port.
"""

from __future__ import annotations

import tempfile
from typing import Optional

from .client import Client
from .server import Server, ServerConfig


class DevAgent:
    """Server + client in one process (the `-dev` mode)."""

    def __init__(
        self,
        data_dir: Optional[str] = None,
        num_workers: int = 2,
        heartbeat_ttl: float = 5.0,
        node=None,
        host_volumes: Optional[dict] = None,
        driver_mode: str = "inprocess",
        device_plugins: Optional[list] = None,
        csi_plugins: Optional[list] = None,
        device="cuda",
    ):
        # resolved before anything is made: an agent asked for CUDA where
        # there is none fails here, with no temp dir or thread left behind
        config = ServerConfig(
            num_workers=num_workers, heartbeat_ttl=heartbeat_ttl, device=device
        )
        self.data_dir = data_dir or tempfile.mkdtemp(prefix="nomad-tpu-dev-")
        self.server = Server(config)
        self.client = Client(
            rpc=self.server.client_rpc(),
            data_dir=self.data_dir,
            node=node,
            host_volumes=host_volumes,
            driver_mode=driver_mode,
            device_plugins=device_plugins,
            csi_plugins=csi_plugins,
        )

    def start(self) -> None:
        self.server.establish_leadership()
        self.client.start()

    def shutdown(self) -> None:
        self.client.shutdown()
        self.server.shutdown()

    # convenience passthroughs
    def register_job(self, job):
        return self.server.register_job(job)

    def deregister_job(self, namespace: str, job_id: str):
        return self.server.deregister_job(namespace, job_id)

    @property
    def store(self):
        return self.server.store
