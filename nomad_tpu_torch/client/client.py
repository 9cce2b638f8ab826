"""Client — the node agent kernel.

Reference: client/client.go (:167 Client): fingerprint + register the
node, heartbeat on the server-assigned TTL, watch allocations (blocking
pull keyed by state index, client.go watchAllocations), reconcile local
AllocRunners against desired state (run new, stop stopped, GC removed),
and sync alloc status back in batches (200 ms batching, client.go:99-101).

The server link is the ``ServerRPC`` seam — in-process for the dev agent,
msgpack/gRPC transport later without touching this file.
"""

from __future__ import annotations

import logging
import threading
import time
from typing import Optional, Protocol

from ..structs import (
    ALLOC_DESIRED_RUN,
    ALLOC_DESIRED_STOP,
    Allocation,
    Node,
)
from .alloc_runner import AllocRunner
from .drivers import builtin_drivers
from .fingerprint import fingerprint_node
from .state import ClientStateDB

log = logging.getLogger("nomad_tpu_torch.client")

ALLOC_SYNC_INTERVAL = 0.2  # client.go:99-101 allocSyncIntv

# terminal alloc dirs retained before the GC sweep reclaims the oldest
# (client/gc.go MaxAllocs-style bound; disk-usage triggers reduce to a
# count bound in this build — the dirs are tiny without artifacts)
GC_MAX_TERMINAL_ALLOCS = 50
GC_INTERVAL = 1.0


class ServerRPC(Protocol):
    def register_node(self, node: Node) -> None: ...

    def heartbeat(self, node_id: str) -> float: ...  # returns TTL seconds

    def pull_allocs(
        self, node_id: str, min_index: int, timeout: float
    ) -> tuple[list[Allocation], int]: ...

    def update_allocs(self, updates: list[Allocation]) -> None: ...


class Client:
    def __init__(
        self,
        rpc: ServerRPC,
        data_dir: str,
        node: Optional[Node] = None,
        heartbeat_interval: Optional[float] = None,
        host_volumes: Optional[dict] = None,
        serve_endpoints: bool = True,
        driver_mode: str = "inprocess",
        device_plugins: Optional[list[str]] = None,
        csi_plugins: Optional[list[str]] = None,
    ):
        self.rpc = rpc
        self.data_dir = data_dir
        self._serve_endpoints = serve_endpoints
        self.endpoints = None
        self.state_db = ClientStateDB(data_dir)
        if driver_mode == "plugin":
            # out-of-process driver plugins (driver.proto contract over
            # stdio NDJSON — client/plugin.py); tasks and their reattach
            # handles survive plugin AND client restarts
            from .plugin import plugin_drivers

            self.drivers = plugin_drivers()
        else:
            self.drivers = builtin_drivers()
        self.node = fingerprint_node(node, data_dir=data_dir, drivers=self.drivers)
        # out-of-process device plugins (device.proto analog — see
        # client/device_plugin.py): fingerprinted groups surface on the
        # node for the scheduler's DeviceChecker/allocator; reservations
        # are resolved at task start into env/mount mutations
        self.device_plugins: dict[str, object] = {}
        # (vendor, type, name) → plugin name: Reserve must route each
        # allocated device group to the plugin that OWNS it (sending ids
        # to every plugin would let e.g. the torch plugin misparse a fake
        # device id into a CUDA ordinal pin)
        self.device_group_owner: dict[tuple, str] = {}
        for dp_name in device_plugins or []:
            from .device_plugin import DevicePluginClient

            dp = DevicePluginClient(dp_name)
            try:
                groups = dp.fingerprint()
            except Exception:
                log.warning("device plugin %s failed", dp_name, exc_info=True)
                continue
            self.device_plugins[dp_name] = dp
            if groups:
                self.node.node_resources.devices.extend(groups)
                for g in groups:
                    self.device_group_owner[
                        (g.vendor, g.type, g.name)
                    ] = dp_name
                self.node.attributes[f"device.{dp_name}"] = str(
                    sum(len(g.instances) for g in groups)
                )
                self.node.compute_class()
        # out-of-process CSI plugins (plugins/csi analog — see
        # client/csi_plugin.py): the alloc runner drives NodeStage/
        # NodePublish through them around task execution
        self.csi_plugins: dict[str, object] = {}
        for cp_name in csi_plugins or []:
            from .csi_plugin import CSIPluginClient

            cp = CSIPluginClient(cp_name)
            if cp.probe():
                from ..structs.volumes import CSINodeInfo

                self.csi_plugins[cp_name] = cp
                # the structured node surface the scheduler's
                # CSIVolumeChecker reads (Node.CSINodePlugins)
                self.node.csi_node_plugins[cp_name] = CSINodeInfo(
                    plugin_id=cp_name, healthy=True
                )
                self.node.attributes[f"csi.{cp_name}"] = "1"
                self.node.compute_class()
            else:
                log.warning("csi plugin %s failed probe", cp_name)
                cp.close()
        if host_volumes:
            # client config host_volume blocks surface on the node for the
            # HostVolumeChecker (structs.ClientHostVolumeConfig)
            self.node.host_volumes.update(host_volumes)
            self.node.compute_class()
        self.heartbeat_interval = heartbeat_interval
        self.runners: dict[str, AllocRunner] = {}
        self._pending_updates: dict[str, Allocation] = {}
        # alloc id → client-side health verdict (allochealth tracker);
        # attached to every subsequent sync so a later task-state update
        # can't erase the verdict in flight
        self._health_verdicts: dict[str, bool] = {}
        self._health_trackers: dict[str, object] = {}
        self._lock = threading.Lock()
        self._logmon_lock = threading.Lock()  # serializes log rotation
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._last_index = 0
        # heartbeatstop (client/heartbeatstop.go:11-40): last server
        # contact; allocs with stop_after_client_disconnect stop when the
        # client has been out of contact longer than their threshold
        self._last_ok_heartbeat = time.time()
        self._heartbeat_stopped: set[str] = set()
        self.gc_max_terminal_allocs = GC_MAX_TERMINAL_ALLOCS
        # terminal alloc ids in completion order (oldest first) for GC
        self._terminal_order: list[str] = []
        # alloc ids whose TERMINAL status the server has acknowledged —
        # only these are GC-eligible (destroying durable state before the
        # ack would let a post-partition reconcile re-run the alloc)
        self._acked_terminal: set[str] = set()
        # telemetry.publish_allocation_metrics (command/agent/config.go
        # Telemetry): per-alloc client-status counters on state changes
        self.publish_allocation_metrics = False

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        self.node.status = "ready"
        if self._serve_endpoints:
            from .endpoints import ATTR_RPC_ADDR, ClientEndpoints

            self.endpoints = ClientEndpoints(self)
            addr = self.endpoints.start()
            # advertised BEFORE registration so fs/logs proxying can reach
            # this node (client/fs_endpoint.go reachability)
            self.node.attributes[ATTR_RPC_ADDR] = addr
        self._restore()
        self.rpc.register_node(self.node)
        for fn, name in (
            (self._heartbeat_loop, "heartbeat"),
            (self._watch_allocations, "alloc-watch"),
            (self._sync_loop, "alloc-sync"),
            (self._gc_loop, "gc"),
            (self._driver_health_loop, "driver-health"),
        ):
            t = threading.Thread(target=fn, name=f"client-{name}", daemon=True)
            t.start()
            self._threads.append(t)

    def shutdown(self, halt_tasks: bool = True) -> None:
        """``halt_tasks=False`` leaves task processes running for a
        restart to re-attach to (the client-restart upgrade path the
        persistent state exists for)."""
        self._stop.set()
        if halt_tasks:
            for r in list(self.runners.values()):
                r.stop()
        for t in self._threads:
            t.join(timeout=2)
        if self.endpoints is not None:
            self.endpoints.stop()
        for d in self.drivers.values():
            close = getattr(d, "close", None)
            if close is not None:
                close()
        for dp in list(self.device_plugins.values()) + list(
            self.csi_plugins.values()
        ):
            try:
                dp.close()
            except Exception:  # noqa: BLE001 — shutdown is best-effort
                pass
        self.state_db.close()

    # -- restore (client/state StateDB; task_runner.go:488-519) -----------
    def _restore(self) -> None:
        for alloc in self.state_db.allocs():
            if alloc.terminal_status() or alloc.desired_status != ALLOC_DESIRED_RUN:
                self.state_db.delete_alloc(alloc.id)
                continue
            handles = self.state_db.handles_for(alloc.id)
            recovered = {}
            for name, h in handles.items():
                driver = self.drivers.get(h.driver)
                if driver is not None and driver.recover(h):
                    recovered[name] = h
                    log.info(
                        "restored task %s/%s (pid %s)", alloc.id[:8], name, h.pid
                    )
            runner = AllocRunner(
                alloc, self.drivers, self.data_dir,
                on_update=self._on_alloc_update,
                restored_handles=recovered,
                on_handle=self.state_db.put_handle,
                device_plugins=self.device_plugins,
                device_group_owner=self.device_group_owner,
                csi_plugins=self.csi_plugins,
                csi_volume_resolver=self._csi_volume_resolver,
            )
            with self._lock:
                self.runners[alloc.id] = runner
            threading.Thread(
                target=runner.run, name=f"alloc-{alloc.id[:8]}", daemon=True
            ).start()
            self._maybe_track_health(runner)

    def _csi_volume_resolver(self, volume_id: str):
        """Server-side volume resolution for CSI publish routing (the
        Node->CSIVolume.Get hop). None when the transport lacks the call
        or the volume is unknown; a TRANSIENT RPC failure RAISES — the
        alloc must fail and retry rather than silently publish an
        unresolved id (which a hostpath-style plugin would materialize
        as a fresh empty volume)."""
        fn = getattr(self.rpc, "csi_volume_info", None)
        if fn is None:
            return None
        try:
            return fn(volume_id)
        except Exception as e:  # noqa: BLE001
            raise RuntimeError(
                f"csi volume resolution failed for {volume_id}: {e}"
            ) from e

    # -- heartbeats --------------------------------------------------------
    def _heartbeat_loop(self) -> None:
        while not self._stop.is_set():
            try:
                ttl = self.rpc.heartbeat(self.node.id)
                self._last_ok_heartbeat = time.time()
                self._heartbeat_stopped.clear()
            except Exception:
                log.warning("heartbeat failed", exc_info=True)
                ttl = 1.0
                self._check_heartbeat_stop()
            interval = self.heartbeat_interval or max(ttl / 2.0, 0.05)
            self._stop.wait(interval)

    def _check_heartbeat_stop(self) -> None:
        """heartbeatstop (client/heartbeatstop.go:11-40): when server
        contact has been lost longer than a group's
        ``stop_after_client_disconnect``, stop its allocs locally — the
        server has already considered them lost and replaced them, so
        letting them run risks a split-brain double-run."""
        elapsed = time.time() - self._last_ok_heartbeat
        with self._lock:
            runners = list(self.runners.items())
        for alloc_id, runner in runners:
            if alloc_id in self._heartbeat_stopped or runner._destroyed:
                continue
            a = runner.alloc
            tg = (
                a.job.lookup_task_group(a.task_group)
                if a.job is not None
                else None
            )
            threshold = (
                tg.stop_after_client_disconnect_s if tg is not None else None
            )
            if threshold is not None and elapsed >= threshold:
                log.info(
                    "heartbeatstop: stopping alloc %s after %.1fs without "
                    "server contact (threshold %.1fs)",
                    alloc_id[:8], elapsed, threshold,
                )
                self._heartbeat_stopped.add(alloc_id)
                runner.stop()

    # -- driver health supervision (client/pluginmanager/drivermanager) ----
    DRIVER_HEALTH_INTERVAL = 5.0

    def _driver_health_loop(self) -> None:
        """The driver-manager loop: periodically re-fingerprint every
        driver and push node updates when health flips, so the scheduler
        stops placing on drivers that died (and resumes when a plugin
        recovers — PluginDriverClient respawns its subprocess lazily, so
        a crashed plugin heals through this same probe)."""
        push_pending = False
        while not self._stop.is_set():
            self._stop.wait(self.DRIVER_HEALTH_INTERVAL)
            if self._stop.is_set():
                return
            changed = False
            for name, drv in self.drivers.items():
                try:
                    healthy = bool(drv.fingerprint())
                except Exception:
                    healthy = False
                if self.node.drivers.get(name) != healthy:
                    self.node.drivers[name] = healthy
                    self.node.attributes[f"driver.{name}"] = (
                        "1" if healthy else "0"
                    )
                    changed = True
                    log.info(
                        "driver %s is now %s",
                        name,
                        "healthy" if healthy else "unhealthy",
                    )
            if changed or push_pending:
                # push_pending: a failed push is retried next tick even
                # though the local state already reflects the change
                self.node.compute_class()
                try:
                    self.rpc.register_node(self.node)
                    push_pending = False
                except Exception:
                    push_pending = True
                    log.exception("node update after driver change failed")

    # -- terminal-alloc GC (client/gc.go) ----------------------------------
    def _gc_loop(self) -> None:
        while not self._stop.is_set():
            self._stop.wait(GC_INTERVAL)
            try:
                self.gc_sweep()
                self.logmon_sweep()
            except Exception:
                log.exception("alloc GC sweep failed")

    def logmon_sweep(self) -> int:
        """Rotate oversized task logs (client/logmon's retention role —
        LogConfig MaxFiles × MaxFileSizeMB, copy-truncate). Serialized:
        two concurrent sweepers would re-rotate a just-truncated file and
        clobber the archived copy with an empty one."""
        from .logmon import sweep_alloc

        with self._lock:
            runners = list(self.runners.values())
        with self._logmon_lock:
            return sum(sweep_alloc(r) for r in runners if not r._destroyed)

    def gc_sweep(self) -> None:
        """Reclaim the oldest terminal alloc dirs beyond the retention
        bound (client/gc.go: disk-driven destroy of terminal allocs; this
        build bounds by count). Allocs whose final status is still
        awaiting server sync are NOT reclaimed — destroying the runner
        and its durable state before the server learns the alloc
        finished would let a post-partition reconcile re-run it."""
        with self._lock:
            self._terminal_order = [
                aid for aid in self._terminal_order if aid in self.runners
            ]
            for alloc_id, runner in self.runners.items():
                if runner.is_terminal() and alloc_id not in self._terminal_order:
                    self._terminal_order.append(alloc_id)
            eligible = [
                aid
                for aid in self._terminal_order
                if aid in self._acked_terminal
            ]
            excess = len(eligible) - self.gc_max_terminal_allocs
            victims = eligible[: max(excess, 0)]
        for alloc_id in victims:
            with self._lock:
                runner = self.runners.pop(alloc_id, None)
                if alloc_id in self._terminal_order:
                    self._terminal_order.remove(alloc_id)
            self._acked_terminal.discard(alloc_id)  # bound the ack set
            self._drop_health_tracking(alloc_id)
            if runner is not None:
                runner.destroy()
            self.state_db.delete_alloc(alloc_id)
            log.info("gc: reclaimed terminal alloc %s", alloc_id[:8])

    # -- alloc pull + reconcile (client.go watchAllocations) ---------------
    def _watch_allocations(self) -> None:
        while not self._stop.is_set():
            try:
                allocs, index = self.rpc.pull_allocs(
                    self.node.id, self._last_index, timeout=1.0
                )
            except Exception:
                log.exception("alloc pull failed")
                self._stop.wait(1.0)
                continue
            if index <= self._last_index:
                continue
            self._last_index = index
            self._reconcile(allocs)

    def _reconcile(self, allocs: list[Allocation]) -> None:
        desired = {a.id: a for a in allocs}
        with self._lock:
            running = dict(self.runners)
        # stop / destroy
        for alloc_id, runner in running.items():
            a = desired.get(alloc_id)
            if a is None:
                runner.destroy()
                self.state_db.delete_alloc(alloc_id)
                self._acked_terminal.discard(alloc_id)
                self._drop_health_tracking(alloc_id)
                with self._lock:
                    self.runners.pop(alloc_id, None)
            elif a.desired_status in (ALLOC_DESIRED_STOP, "evict"):
                self._drop_health_tracking(alloc_id)
                if not runner._destroyed:
                    runner.stop()
        # start new
        for alloc_id, a in desired.items():
            if a.desired_status != ALLOC_DESIRED_RUN:
                continue
            if a.terminal_status() or alloc_id in running:
                continue
            self.state_db.put_alloc(a)
            runner = AllocRunner(
                a, self.drivers, self.data_dir,
                on_update=self._on_alloc_update,
                on_handle=self.state_db.put_handle,
                prev_watcher=self._watch_previous_alloc,
                device_plugins=self.device_plugins,
                device_group_owner=self.device_group_owner,
                csi_plugins=self.csi_plugins,
                csi_volume_resolver=self._csi_volume_resolver,
            )
            with self._lock:
                self.runners[alloc_id] = runner
            threading.Thread(
                target=runner.run, name=f"alloc-{alloc_id[:8]}", daemon=True
            ).start()
            self._maybe_track_health(runner)

    def _watch_previous_alloc(self, prev_id: str, timeout: float = 60.0):
        """allocwatcher (client/allocwatcher): block until the previous
        allocation's local runner reaches a terminal state; returns its
        alloc dir for migration. None ⇒ previous alloc is remote or
        already reclaimed (the reference would pull the dir over the
        node API; descoped to same-node migration)."""
        deadline = time.time() + timeout
        while time.time() < deadline and not self._stop.is_set():
            with self._lock:
                runner = self.runners.get(prev_id)
            if runner is None:
                return None
            if runner._destroyed or runner.is_terminal():
                return runner.alloc_dir
            time.sleep(0.05)
        return None

    # -- alloc health (client/allochealth tracker) -------------------------
    def _maybe_track_health(self, runner) -> None:
        """Deployment allocs get a health tracker: task states + service
        checks gate DeploymentStatus.Healthy (tracker.go). Checkless
        groups stay on the server-side continuous-running fallback."""
        alloc = runner.alloc
        if not getattr(alloc, "deployment_id", None):
            return
        from .allochealth import AllocHealthTracker, group_checks

        if not group_checks(alloc.job, alloc.task_group):
            return  # no checks: server-side task_states fallback applies
        job = alloc.job
        tg = job.lookup_task_group(alloc.task_group) if job else None
        tracker = AllocHealthTracker(
            runner,
            getattr(tg, "update", None),
            on_health=self._on_alloc_health,
        )
        with self._lock:
            self._health_trackers[alloc.id] = tracker
        tracker.start()

    def _drop_health_tracking(self, alloc_id: str) -> None:
        """Stop the tracker and prune the verdict when an alloc leaves
        this client (stopped/GC'd) — a live tracker would keep probing
        ports that may already belong to a new alloc."""
        with self._lock:
            tracker = self._health_trackers.pop(alloc_id, None)
            self._health_verdicts.pop(alloc_id, None)
        if tracker is not None:
            tracker.stop()

    def _on_alloc_health(self, alloc_id: str, healthy: bool) -> None:
        from ..structs.deployment import AllocDeploymentStatus

        with self._lock:
            self._health_verdicts[alloc_id] = healthy
            runner = self.runners.get(alloc_id)
        if runner is None:
            return
        upd = runner.alloc.copy_for_update()
        # client_status is the task lifecycle's to report — health is a
        # separate verdict; the verdict rides the regular alloc sync and
        # the store merges it onto the server copy for the watcher
        upd.deployment_status = AllocDeploymentStatus(
            healthy=healthy, timestamp_unix=time.time()
        )
        upd.task_states = {
            name: {
                "state": s.state,
                "failed": s.failed,
                "restarts": s.restarts,
            }
            for name, s in runner.task_states.items()
        }
        with self._lock:
            self._pending_updates[alloc_id] = upd
        self.state_db.put_alloc(upd)

    # -- status sync -------------------------------------------------------
    def _on_alloc_update(self, alloc: Allocation, status: str, task_states) -> None:
        upd = alloc.copy_for_update()
        upd.client_status = status
        upd.task_states = {
            name: {"state": s.state, "failed": s.failed, "restarts": s.restarts}
            for name, s in task_states.items()
        }
        verdict = self._health_verdicts.get(alloc.id)
        if verdict is not None:
            from ..structs.deployment import AllocDeploymentStatus

            upd.deployment_status = AllocDeploymentStatus(
                healthy=verdict, timestamp_unix=time.time()
            )
        with self._lock:
            self._pending_updates[alloc.id] = upd
        if self.publish_allocation_metrics:
            from ..utils.metrics import global_metrics

            global_metrics.incr(f"nomad.client.allocations.{status}")
        # keep the durable copy's status current so a restart doesn't
        # re-run an already-finished alloc
        self.state_db.put_alloc(upd)

    def _sync_loop(self) -> None:
        while not self._stop.is_set():
            self._stop.wait(ALLOC_SYNC_INTERVAL)
            with self._lock:
                batch = list(self._pending_updates.values())
                self._pending_updates.clear()
            if batch:
                try:
                    self.rpc.update_allocs(batch)
                    self._acked_terminal.update(
                        u.id for u in batch if u.terminal_status()
                    )
                except Exception:
                    log.exception("alloc status sync failed")
                    with self._lock:
                        for u in batch:
                            self._pending_updates.setdefault(u.id, u)

    # -- introspection -----------------------------------------------------
    def num_allocs(self) -> int:
        with self._lock:
            return len(self.runners)
