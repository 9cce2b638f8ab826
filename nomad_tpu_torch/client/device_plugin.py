"""Out-of-process DEVICE plugin contract — the device.proto analog.

Reference: plugins/device/proto/device.proto + plugins/device/device.go:
a device plugin is a separate process the client talks to over a typed
contract with three calls — ``Fingerprint`` (stream of detected device
groups), ``Reserve`` (instance ids → container/env mutations), and
``Stats`` (per-instance usage). The reference speaks gRPC to a hashicorp
go-plugin binary; this build reuses the framework's NDJSON stdio plugin
transport (client/plugin.py's wire style), so device plugins get the
same lifecycle/reattach properties as driver plugins without a protobuf
toolchain.

Wire protocol (one JSON object per line):
  plugin → host  {"type": "handshake", "magic": ..., "version": 1,
                  "plugin": "<name>"}
  host → plugin  {"id": N, "method": "fingerprint" | "reserve" | "stats",
                  "params": {...}}
  plugin → host  {"id": N, "result": ...} | {"id": N, "error": "..."}

A plugin is any executable speaking this protocol; the builtin launcher
(``python -m nomad_tpu_torch.client.device_plugin <name>``) serves the
plugins registered in BUILTIN_DEVICE_PLUGINS (the ``torch.cuda`` plugin
and a test fake), mirroring how driver plugins are spawned.
"""

from __future__ import annotations

import os
import sys
from typing import Optional

from ..structs.resources import NodeDeviceInstance, NodeDeviceResource
from .stdio_plugin import StdioPluginClient, serve_stdio_plugin

DEVICE_PLUGIN_MAGIC = "NOMAD_TPU_DEVICE_V1"
DEVICE_PROTO_VERSION = 1


class DevicePlugin:
    """Base class for the plugin-side implementation."""

    name = "device"

    def fingerprint(self) -> list[dict]:
        """Detected device groups: [{vendor, type, name, instances:
        [{id, healthy}], attributes: {...}}]."""
        return []

    def reserve(self, device_ids: list[str]) -> dict:
        """Reservation response (device.proto ContainerReservation):
        {"envs": {...}, "mounts": [...], "devices": [...]}."""
        return {"envs": {}, "mounts": [], "devices": []}

    def stats(self) -> dict:
        """Per-instance stats: {instance_id: {...}}."""
        return {}


class TorchDevicePlugin(DevicePlugin):
    """The native accelerator plugin: surfaces the ``torch.cuda`` device
    table (the NVIDIA cards this host's CUDA sees) as one schedulable
    device group — the drivers/gpu analog for this framework's own
    hardware. ``torch`` is imported inside the calls, so the plugin host
    and the other builtin plugins start without it."""

    name = "torch"

    def fingerprint(self) -> list[dict]:
        import torch

        # a host without CUDA advertises no device; any other failure
        # (a broken driver, a lost card) propagates to the client's log
        if not torch.cuda.is_available():
            return []
        count = torch.cuda.device_count()
        return [
            {
                "vendor": "nvidia",
                "type": "gpu",
                "name": torch.cuda.get_device_name(0)
                .replace(" ", "-")
                .lower(),
                "instances": [
                    {"id": f"cuda-{i}", "healthy": True}
                    for i in range(count)
                ],
                "attributes": {"count": count},
            }
        ]

    def reserve(self, device_ids: list[str]) -> dict:
        ordinals = ",".join(
            did.rsplit("-", 1)[-1] for did in device_ids
        )
        # the visibility knob CUDA runtimes honor
        return {
            "envs": {"CUDA_VISIBLE_DEVICES": ordinals},
            "mounts": [],
            "devices": [],
        }


class FakeDevicePlugin(DevicePlugin):
    """Deterministic test plugin: devices configured via env."""

    name = "fake"

    def fingerprint(self) -> list[dict]:
        spec = os.environ.get("NOMAD_FAKE_DEVICES", "")
        if not spec:
            return []
        # "vendor/type/name:n"
        head, _, n = spec.partition(":")
        vendor, type_, name = head.split("/")
        return [
            {
                "vendor": vendor,
                "type": type_,
                "name": name,
                "instances": [
                    {"id": f"{name}-{i}", "healthy": True}
                    for i in range(int(n or 1))
                ],
                "attributes": {"memory_mb": 1024},
            }
        ]

    def reserve(self, device_ids: list[str]) -> dict:
        return {
            "envs": {"FAKE_VISIBLE_DEVICES": ",".join(device_ids)},
            "mounts": [],
            "devices": [f"/dev/fake/{d}" for d in device_ids],
        }

    def stats(self) -> dict:
        return {
            d["id"]: {"utilization": 0.0}
            for g in self.fingerprint()
            for d in g["instances"]
        }


BUILTIN_DEVICE_PLUGINS = {
    p.name: p for p in (TorchDevicePlugin(), FakeDevicePlugin())
}


# -- plugin (server) side ----------------------------------------------------


def serve_device_plugin(plugin: DevicePlugin, stdin=None, stdout=None):
    serve_stdio_plugin(
        DEVICE_PLUGIN_MAGIC,
        DEVICE_PROTO_VERSION,
        plugin.name,
        {
            "fingerprint": lambda p: plugin.fingerprint(),
            "reserve": lambda p: plugin.reserve(
                p.get("device_ids") or []
            ),
            "stats": lambda p: plugin.stats(),
        },
        stdin=stdin,
        stdout=stdout,
    )


# -- host (client) side ------------------------------------------------------


class DevicePluginClient(StdioPluginClient):
    """Spawns and drives one device plugin subprocess."""

    MAGIC = DEVICE_PLUGIN_MAGIC
    VERSION = DEVICE_PROTO_VERSION

    def default_argv(self, name: str) -> list[str]:
        return [
            sys.executable, "-m", "nomad_tpu_torch.client.device_plugin", name,
        ]

    # -- contract ----------------------------------------------------------
    def fingerprint(self) -> list[NodeDeviceResource]:
        groups = self._call("fingerprint") or []
        out = []
        for g in groups:
            out.append(
                NodeDeviceResource(
                    vendor=g.get("vendor", ""),
                    type=g.get("type", ""),
                    name=g.get("name", ""),
                    instances=[
                        NodeDeviceInstance(
                            id=i.get("id", ""),
                            healthy=bool(i.get("healthy", True)),
                        )
                        for i in g.get("instances", [])
                    ],
                    attributes=dict(g.get("attributes") or {}),
                )
            )
        return out

    def reserve(self, device_ids: list[str]) -> dict:
        return self._call("reserve", {"device_ids": device_ids}) or {}

    def stats(self) -> dict:
        return self._call("stats") or {}


def _main() -> None:
    name = sys.argv[1] if len(sys.argv) > 1 else "fake"
    plugin = BUILTIN_DEVICE_PLUGINS.get(name)
    if plugin is None:
        print(f"unknown device plugin {name!r}", file=sys.stderr)
        raise SystemExit(2)
    serve_device_plugin(plugin)


if __name__ == "__main__":
    _main()
