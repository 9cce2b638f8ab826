"""AllocRunner — per-allocation supervisor.

Reference: client/allocrunner/alloc_runner.go (:36-120): set up the alloc
dir, run one TaskRunner per task (leader/sidecar ordering via the task
hook coordinator is honored in its simplest form: all mains in parallel),
aggregate task states into the alloc's client status, and report changes
up to the client for batched server sync.

Client status derivation mirrors getClientStatus (alloc_runner.go):
any task failed ⇒ failed; any running ⇒ running; all dead+ok ⇒ complete.
"""

from __future__ import annotations

import logging
import os
import shutil
import threading
from typing import Callable, Optional

from ..structs import (
    ALLOC_CLIENT_COMPLETE,
    ALLOC_CLIENT_FAILED,
    ALLOC_CLIENT_PENDING,
    ALLOC_CLIENT_RUNNING,
    Allocation,
)
from .task_runner import TaskRunner, TaskState

log = logging.getLogger("nomad_tpu_torch.alloc_runner")


class AllocRunner:
    def __init__(
        self,
        alloc: Allocation,
        drivers: dict,
        data_dir: str,
        on_update: Optional[Callable[[Allocation, str, dict], None]] = None,
        restored_handles: Optional[dict] = None,
        on_handle: Optional[Callable] = None,
        prev_watcher: Optional[Callable] = None,
        device_plugins: Optional[dict] = None,
        device_group_owner: Optional[dict] = None,
        csi_plugins: Optional[dict] = None,
        csi_volume_resolver: Optional[Callable] = None,
    ):
        self.alloc = alloc
        self.drivers = drivers
        self.alloc_dir = os.path.join(data_dir, "allocs", alloc.id)
        self.on_update = on_update
        # allocwatcher seam (client/allocwatcher): blocks until the
        # previous allocation stops and returns its alloc dir for
        # ephemeral-disk migration (None = remote/unknown previous)
        self.prev_watcher = prev_watcher
        # task_name → recovered TaskHandle (client restart re-attach)
        self.restored_handles = restored_handles or {}
        self.on_handle = on_handle
        # device-plugin clients (name → DevicePluginClient) for Reserve,
        # plus the (vendor, type, name) → plugin-name ownership map
        self.device_plugins = device_plugins or {}
        self.device_group_owner = device_group_owner or {}
        # CSI plugin clients (name → CSIPluginClient) for the
        # stage/publish lifecycle; published (plugin, volume_id, target)
        # triples recorded for teardown
        self.csi_plugins = csi_plugins or {}
        # volume_id -> (resolved_id, plugin_id) via the server (routing +
        # per_alloc fallback); None in plugin-less/standalone setups
        self.csi_volume_resolver = csi_volume_resolver
        self._published_volumes: list[tuple] = []
        self.task_runners: dict[str, TaskRunner] = {}
        self.task_states: dict[str, TaskState] = {}
        self._lock = threading.Lock()
        self._destroyed = False

    # -- lifecycle ---------------------------------------------------------
    def run(self) -> None:
        job = self.alloc.job
        tg = job.lookup_task_group(self.alloc.task_group) if job else None
        if tg is None:
            self._report(ALLOC_CLIENT_FAILED, "unknown task group")
            return
        os.makedirs(self.alloc_dir, exist_ok=True)
        self._migrate_previous(tg)
        env = {
            "NOMAD_ALLOC_ID": self.alloc.id,
            "NOMAD_ALLOC_NAME": self.alloc.name,
            "NOMAD_ALLOC_INDEX": str(self.alloc.index()),
            "NOMAD_ALLOC_DIR": os.path.join(self.alloc_dir, "shared"),
            "NOMAD_JOB_NAME": job.name if job else "",
            "NOMAD_GROUP_NAME": tg.name,
        }
        os.makedirs(env["NOMAD_ALLOC_DIR"], exist_ok=True)
        try:
            env.update(self._reserve_devices())
            env.update(self._publish_csi_volumes(tg))
        except RuntimeError as e:
            log.warning("alloc %s: %s", self.alloc.id[:8], e)
            self._report(ALLOC_CLIENT_FAILED, str(e))
            return
        for task in tg.tasks:
            driver = self.drivers.get(task.driver)
            if driver is None:
                self._report(
                    ALLOC_CLIENT_FAILED, f"driver {task.driver!r} not found"
                )
                return
            tr = TaskRunner(
                task=task,
                driver=driver,
                task_dir=os.path.join(self.alloc_dir, task.name),
                env=env,
                restart_policy=tg.restart_policy,
                on_state_change=self._on_task_state,
                attach_handle=self.restored_handles.get(task.name),
                on_handle=(
                    (lambda name, h: self.on_handle(self.alloc.id, name, h))
                    if self.on_handle is not None else None
                ),
            )
            self.task_runners[task.name] = tr
        for tr in self.task_runners.values():
            tr.start()
        self._report(ALLOC_CLIENT_RUNNING, "tasks are running")

    def _reserve_devices(self) -> dict:
        """Resolve the alloc's scheduled device instances through the
        device plugins (device.proto Reserve): each AllocatedDeviceResource
        routes to the plugin that OWNS its (vendor, type, name) group, and
        the reservation's env mutations flow into every task's environment
        (the reference mutates the container config; env is this build's
        common denominator across drivers). A failed reservation FAILS the
        alloc — starting without device isolation would let the task use
        instances reserved by other allocs."""
        assigned = getattr(self.alloc, "allocated_devices", None) or []
        if not assigned:
            return {}
        if not self.device_plugins:
            # scheduled device instances with no plugin to reserve them
            # (e.g. the plugin failed fingerprint on restart): starting
            # unconfined would let the task use other allocs' instances
            raise RuntimeError(
                "alloc has allocated devices but no device plugin is "
                "available to reserve them"
            )
        envs: dict = {}
        for ad in assigned:
            ids = list(getattr(ad, "device_ids", None) or [])
            if not ids:
                continue
            owner = self.device_group_owner.get(
                (ad.vendor, ad.type, ad.name)
            )
            dp = self.device_plugins.get(owner) if owner else None
            if dp is None:
                raise RuntimeError(
                    f"no device plugin owns group "
                    f"{ad.vendor}/{ad.type}/{ad.name}"
                )
            try:
                res = dp.reserve(ids)
            except Exception as e:
                raise RuntimeError(
                    f"device reserve failed for "
                    f"{ad.vendor}/{ad.type}/{ad.name}: {e}"
                ) from e
            envs.update(res.get("envs") or {})
        return envs

    def _publish_csi_volumes(self, tg) -> dict:
        """Stage + publish each CSI volume request through the plugin
        that OWNS it (csimanager/volume.go's NodeStage→NodePublish half;
        the server's claim lifecycle already gated scheduling). The
        volume resolves through the server (``csi_volume_info``) so the
        published id and the claimed id agree — including the per_alloc
        fallback to the base source the scheduler and applier use. The
        published path is exposed at <alloc_dir>/volumes/<name> and as
        NOMAD_VOLUME_<NAME> in every task's env. Failures FAIL the alloc
        (with staged-but-unpublished volumes unstaged and earlier
        publishes torn down) — running without a declared volume is the
        reference's failure mode too."""
        volumes = getattr(tg, "volumes", None) or {}
        csi_reqs = {
            name: req
            for name, req in volumes.items()
            if getattr(req, "type", "") == "csi"
        }
        if not csi_reqs:
            return {}
        if not self.csi_plugins:
            raise RuntimeError(
                "alloc requests CSI volumes but no CSI plugin is available"
            )
        envs: dict = {}
        staging_root = os.path.join(self.alloc_dir, "csi-staging")
        try:
            for name, req in csi_reqs.items():
                vol_id = req.source
                if getattr(req, "per_alloc", False):
                    vol_id = f"{req.source}[{self.alloc.index()}]"
                plugin_id = None
                if self.csi_volume_resolver is not None:
                    info = self.csi_volume_resolver(vol_id)
                    if info is not None:
                        # server-resolved id (per_alloc falls back to the
                        # base source exactly like scheduling/apply did)
                        vol_id, plugin_id = info
                if plugin_id is not None:
                    plugin = self.csi_plugins.get(plugin_id)
                    if plugin is None:
                        raise RuntimeError(
                            f"volume {vol_id} needs CSI plugin "
                            f"{plugin_id!r}, which this node does not run"
                        )
                elif len(self.csi_plugins) == 1:
                    plugin = next(iter(self.csi_plugins.values()))
                else:
                    raise RuntimeError(
                        f"cannot route volume {vol_id}: no resolver and "
                        f"{len(self.csi_plugins)} plugins configured"
                    )
                target = os.path.join(self.alloc_dir, "volumes", name)
                staged = False
                try:
                    plugin.node_stage(
                        vol_id, os.path.join(staging_root, name)
                    )
                    staged = True
                    plugin.node_publish(
                        vol_id, target,
                        read_only=getattr(req, "read_only", False),
                    )
                except Exception as e:
                    if staged:
                        # stage succeeded, publish failed: a real driver
                        # would leak the staged mount otherwise
                        try:
                            plugin.node_unstage(vol_id)
                        except Exception:  # noqa: BLE001
                            pass
                    raise RuntimeError(
                        f"csi volume {name} ({vol_id}): {e}"
                    ) from e
                self._published_volumes.append((plugin, vol_id, target))
                envs[
                    f"NOMAD_VOLUME_{name.upper().replace('-', '_')}"
                ] = target
        except RuntimeError:
            # tear down whatever already published for this alloc — a
            # failed alloc must not hold volumes mounted
            self._unpublish_csi_volumes()
            raise
        return envs

    def _unpublish_csi_volumes(self) -> None:
        for plugin, vol_id, target in self._published_volumes:
            # separate trys: a failed unpublish must not skip the
            # unstage (that would leak the staged mount)
            try:
                plugin.node_unpublish(vol_id, target)
            except Exception:  # noqa: BLE001 — teardown is best-effort
                log.warning(
                    "csi unpublish failed for %s", vol_id, exc_info=True
                )
            try:
                plugin.node_unstage(vol_id)
            except Exception:  # noqa: BLE001
                log.warning(
                    "csi unstage failed for %s", vol_id, exc_info=True
                )
        self._published_volumes = []

    def _migrate_previous(self, tg) -> None:
        """Previous-alloc data migration (client/allocwatcher +
        migrate_hook): with ephemeral_disk.migrate/sticky, wait for the
        previous allocation to stop, then carry its shared dir into this
        alloc. The reference streams remote dirs over the node API; this
        build migrates same-node dirs and degrades to wait-only for
        remote previous allocs."""
        prev = self.alloc.previous_allocation
        ed = getattr(tg, "ephemeral_disk", None)
        if not prev or self.prev_watcher is None or ed is None:
            return
        if not (ed.migrate or ed.sticky):
            return
        src_dir = self.prev_watcher(prev)
        if not src_dir:
            return
        src_shared = os.path.join(src_dir, "shared")
        dst_shared = os.path.join(self.alloc_dir, "shared")
        try:
            if os.path.isdir(src_shared):
                shutil.copytree(src_shared, dst_shared, dirs_exist_ok=True)
        except (OSError, shutil.Error):
            # the previous dir can be GC'd/destroyed concurrently — a
            # failed migration degrades to a fresh disk, never a stuck
            # alloc (run() has no other guard above the task loop)
            pass

    def wait(self, timeout: Optional[float] = None) -> None:
        for tr in self.task_runners.values():
            tr.join(timeout=timeout)

    def stop(self) -> None:
        """Graceful stop (desired_status=stop): leader-last kill order."""
        for tr in self.task_runners.values():
            tr.kill()
        self._unpublish_csi_volumes()
        self._report(self.client_status(), "alloc stopped")

    def destroy(self) -> None:
        """GC: stop + remove the alloc dir (client/gc.go)."""
        self.stop()
        self._destroyed = True
        shutil.rmtree(self.alloc_dir, ignore_errors=True)

    # -- status ------------------------------------------------------------
    def _on_task_state(self, name: str, state: TaskState) -> None:
        with self._lock:
            self.task_states[name] = state
        self._report(self.client_status(), "")

    def client_status(self) -> str:
        states = list(self.task_states.values())
        if not states:
            return ALLOC_CLIENT_PENDING
        if any(s.failed for s in states):
            return ALLOC_CLIENT_FAILED
        if any(s.state == "running" for s in states):
            return ALLOC_CLIENT_RUNNING
        if all(s.state == "dead" for s in states):
            return ALLOC_CLIENT_COMPLETE
        return ALLOC_CLIENT_PENDING

    def is_terminal(self) -> bool:
        states = list(self.task_states.values())
        return bool(states) and all(s.state == "dead" for s in states)

    def _report(self, status: str, desc: str) -> None:
        if self.on_update is not None:
            self.on_update(self.alloc, status, dict(self.task_states))
