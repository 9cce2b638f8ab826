"""Out-of-process CSI plugin contract — the plugins/csi analog.

Reference: plugins/csi/ (client.go: a gRPC client to an external CSI
driver's controller/node services over its unix socket; the volume
lifecycle is ControllerPublish → NodeStage → NodePublish and the reverse
on teardown, csimanager/volume.go). The server side of this build
already models volumes/claims/plugins and re-verifies claims in the plan
applier; this module adds the CLIENT-side external contract: a CSI
plugin is a separate process speaking CSI-shaped calls over the
framework's NDJSON stdio transport (uniform with driver and device
plugins — no protobuf toolchain), and the alloc runner drives the
stage/publish lifecycle around task execution.

Methods (CSI spec names, trimmed to the implemented semantics):
  probe                         → {"ready": bool}
  controller_publish            {volume_id, node_id}        → {}
  controller_unpublish          {volume_id, node_id}        → {}
  node_stage                    {volume_id, staging_path}   → {}
  node_unstage                  {volume_id}                 → {}
  node_publish                  {volume_id, target_path,
                                 read_only}                 → {}
  node_unpublish                {volume_id, target_path}    → {}

``HostPathCSIPlugin`` is the bundled reference implementation (the
csi-driver-host-path analog): volumes are directories under a root, and
publish materializes them at the target path — real enough to carry
data between allocs in tests and single-node deployments.
"""

from __future__ import annotations

import os
import shutil
import sys
from typing import Optional

from .stdio_plugin import StdioPluginClient, serve_stdio_plugin

CSI_PLUGIN_MAGIC = "NOMAD_TPU_CSI_V1"
CSI_PROTO_VERSION = 1


class CSIPlugin:
    """Plugin-side base."""

    name = "csi"

    def probe(self) -> dict:
        return {"ready": True}

    def controller_publish(self, volume_id: str, node_id: str) -> dict:
        return {}

    def controller_unpublish(self, volume_id: str, node_id: str) -> dict:
        return {}

    def node_stage(self, volume_id: str, staging_path: str) -> dict:
        return {}

    def node_unstage(self, volume_id: str) -> dict:
        return {}

    def node_publish(
        self, volume_id: str, target_path: str, read_only: bool
    ) -> dict:
        return {}

    def node_unpublish(self, volume_id: str, target_path: str) -> dict:
        return {}


class HostPathCSIPlugin(CSIPlugin):
    """csi-driver-host-path analog: volume_id ↔ a directory under
    ``root`` (env NOMAD_CSI_HOSTPATH_ROOT, default /tmp/nomad-csi).
    Publish materializes the volume at target_path via symlink, so data
    written by one alloc is visible to the next — the property the CSI
    lifecycle exists to provide.

    Known limitation: ``read_only`` is accepted but NOT enforced — the
    symlink is writable either way (a faithful read-only publish needs a
    bind mount or an overlay, which this reference plugin deliberately
    avoids). The server-side claim accounting still enforces access-mode
    admission; a misbehaving "reader" task can violate it here. Real CSI
    drivers enforce read-only at the mount."""

    name = "hostpath"

    def __init__(self, root: Optional[str] = None):
        self.root = root or os.environ.get(
            "NOMAD_CSI_HOSTPATH_ROOT", "/tmp/nomad-csi"
        )
        self._staged: set[str] = set()

    def _vol_dir(self, volume_id: str) -> str:
        safe = volume_id.replace("/", "_")
        return os.path.join(self.root, safe)

    def node_stage(self, volume_id: str, staging_path: str) -> dict:
        os.makedirs(self._vol_dir(volume_id), exist_ok=True)
        self._staged.add(volume_id)
        return {}

    def node_unstage(self, volume_id: str) -> dict:
        self._staged.discard(volume_id)
        return {}

    def node_publish(
        self, volume_id: str, target_path: str, read_only: bool
    ) -> dict:
        if volume_id not in self._staged:
            raise RuntimeError(f"volume {volume_id} not staged")
        vol = self._vol_dir(volume_id)
        os.makedirs(os.path.dirname(target_path), exist_ok=True)
        if os.path.islink(target_path):
            os.unlink(target_path)
        elif os.path.isdir(target_path):
            shutil.rmtree(target_path)
        os.symlink(vol, target_path)
        return {}

    def node_unpublish(self, volume_id: str, target_path: str) -> dict:
        if os.path.islink(target_path):
            os.unlink(target_path)
        return {}


BUILTIN_CSI_PLUGINS = {"hostpath": HostPathCSIPlugin}


# -- plugin (server) side ----------------------------------------------------


def serve_csi_plugin(plugin: CSIPlugin, stdin=None, stdout=None) -> None:
    serve_stdio_plugin(
        CSI_PLUGIN_MAGIC,
        CSI_PROTO_VERSION,
        plugin.name,
        {
            "probe": lambda p: plugin.probe(),
            "controller_publish": lambda p: plugin.controller_publish(
                p["volume_id"], p["node_id"]
            ),
            "controller_unpublish": lambda p: plugin.controller_unpublish(
                p["volume_id"], p["node_id"]
            ),
            "node_stage": lambda p: plugin.node_stage(
                p["volume_id"], p["staging_path"]
            ),
            "node_unstage": lambda p: plugin.node_unstage(
                p["volume_id"]
            ),
            "node_publish": lambda p: plugin.node_publish(
                p["volume_id"], p["target_path"],
                bool(p.get("read_only")),
            ),
            "node_unpublish": lambda p: plugin.node_unpublish(
                p["volume_id"], p["target_path"]
            ),
        },
        stdin=stdin,
        stdout=stdout,
    )


# -- host (client) side ------------------------------------------------------


class CSIPluginClient(StdioPluginClient):
    """Spawns and drives one CSI plugin subprocess (csimanager's
    instance-manager role)."""

    MAGIC = CSI_PLUGIN_MAGIC
    VERSION = CSI_PROTO_VERSION

    def default_argv(self, name: str) -> list[str]:
        return [
            sys.executable, "-m", "nomad_tpu_torch.client.csi_plugin", name,
        ]

    # -- contract ----------------------------------------------------------
    def probe(self) -> bool:
        try:
            return bool((self._call("probe") or {}).get("ready"))
        except (RuntimeError, OSError):
            return False

    def node_stage(self, volume_id: str, staging_path: str) -> None:
        self._call(
            "node_stage",
            {"volume_id": volume_id, "staging_path": staging_path},
        )

    def node_unstage(self, volume_id: str) -> None:
        self._call("node_unstage", {"volume_id": volume_id})

    def node_publish(
        self, volume_id: str, target_path: str, read_only: bool = False
    ) -> None:
        self._call(
            "node_publish",
            {
                "volume_id": volume_id,
                "target_path": target_path,
                "read_only": read_only,
            },
        )

    def node_unpublish(self, volume_id: str, target_path: str) -> None:
        self._call(
            "node_unpublish",
            {"volume_id": volume_id, "target_path": target_path},
        )


def _main() -> None:
    name = sys.argv[1] if len(sys.argv) > 1 else "hostpath"
    factory = BUILTIN_CSI_PLUGINS.get(name)
    if factory is None:
        print(f"unknown csi plugin {name!r}", file=sys.stderr)
        raise SystemExit(2)
    serve_csi_plugin(factory())


if __name__ == "__main__":
    _main()
