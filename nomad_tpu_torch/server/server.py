"""Server — the composition root: state, queues, applier, workers.

Reference: nomad/server.go (:95-259 Server, :293 NewServer) and
nomad/leader.go (:230-347 establishLeadership: enable plan queue, spawn
planApply, enable eval broker + blocked evals, restore queues from durable
state, pause half the workers).

Every cluster write is a typed FSM message (server/fsm.py) submitted
through ``raft_apply`` — backed by InlineRaft (single server, optional WAL
durability + replay-on-boot) or a full RaftNode consensus group
(nomad_tpu_torch.raft, swapped in by ``attach_raft`` when a
``ClusterServer`` owns the server). Mirrors nomad/server.go: endpoints
build requests, the FSM is the only state-store writer.

The port's server schedules through broker → worker → plan queue →
applier, over the one ``DeviceStateCache`` on ``ServerConfig.device`` that
every worker shares (default ``"cuda"``, which raises without CUDA; tests
pass ``"cpu"``), and runs the reference's leader services: admission,
heartbeats, the deployment watcher, the drainer, periodic dispatch, core
GC, the volume watcher, ACL and the defrag controller, which plans each
cycle with the migration kernel on the same device. In a cluster
(``server/cluster.py``) each member builds its own server on its own
device; only the leader runs these services, so only the leader's
process launches kernels.
"""

from __future__ import annotations

import logging
import threading
from typing import Iterable, Optional

from ..backend import resolve_device
from ..broker.blocked import BlockedEvals
from ..broker.eval_broker import EvalBroker
from ..broker.plan_queue import PlanApplyLoop, PlanQueue
from ..state import StateStore
from ..structs import (
    EVAL_STATUS_BLOCKED,
    EVAL_STATUS_PENDING,
    Allocation,
    Evaluation,
    Job,
    Node,
    TRIGGER_JOB_REGISTER,
    TRIGGER_NODE_UPDATE,
    new_id,
)
from ..structs.job import validate_job
from ..structs.evaluation import (
    TRIGGER_JOB_DEREGISTER,
    TRIGGER_RETRY_FAILED_ALLOC,
)
from .worker import Worker

log = logging.getLogger("nomad_tpu_torch.server")


class ServerConfig:
    def __init__(
        self,
        num_workers: int = 2,
        region: str = "global",
        heartbeat_ttl: float = 5.0,
        deployment_watch_interval: float = 0.25,
        acl_enabled: bool = False,
        data_dir: Optional[str] = None,
        num_batch_workers: int = 1,
        num_lanes: int = 16,
        lane_mode: Optional[bool] = None,
        clock=None,
        eval_deadline: Optional[float] = None,
        eval_attempt_limit: Optional[int] = None,
        admission_overrides: Optional[dict] = None,
        calibration_artifact: Optional[str] = None,
        defrag_interval: float = 0.0,
        defrag_budget: int = 4,
        device="cuda",
    ):
        import os

        # the device every worker's kernels run on: one DeviceStateCache
        # there, shared by the workers. Resolved here, so a server asked
        # for CUDA where there is none fails at construction.
        self.device = resolve_device(device)
        self.num_workers = num_workers
        self.region = region
        self.heartbeat_ttl = heartbeat_ttl
        self.deployment_watch_interval = deployment_watch_interval
        self.acl_enabled = acl_enabled
        self.data_dir = data_dir
        # per-eval processing deadline in the worker (resilience layer):
        # an eval whose pass outlives this is nacked with escalating
        # delay; after eval_attempt_limit expiries it is marked failed
        # with a structured reason. <= 0 disables the deadline.
        if eval_deadline is None:
            eval_deadline = float(
                os.environ.get("NOMAD_TPU_EVAL_DEADLINE", "60")
            )
        self.eval_deadline = eval_deadline
        if eval_attempt_limit is None:
            eval_attempt_limit = int(
                os.environ.get("NOMAD_TPU_EVAL_ATTEMPT_LIMIT", "3")
            )
        self.eval_attempt_limit = eval_attempt_limit
        # injectable cluster clock: an object with time() and
        # monotonic(). Threaded into the eval broker's delay/unack
        # deadlines, the worker's eval deadlines, the admission
        # controller and the heartbeater's TTL timers; None means the
        # real clock.
        self.clock = clock
        # workers 0..n-1 run batched device passes, each on its own
        # job-hash partition of the eval stream (the rest drain solo
        # evals). >1 needs the broker's partitioned queues so two
        # batched passes never carry the same jobs.
        self.num_batch_workers = max(1, min(num_batch_workers, num_workers or 1))
        # deterministic lane map size (server/lanes.py). A CONSTANT with
        # respect to the worker count — placement must be a function of
        # (job, cluster state) only, so re-running with more workers
        # yields byte-identical placements — clamped so every batching
        # worker owns at least one lane.
        self.num_lanes = max(int(num_lanes), self.num_batch_workers, 1)
        # lane mode auto-enables with >1 batching worker. The explicit
        # override exists for the byte-identity harness: a 1-worker
        # reference run must take the SAME code path (lane-salted batch
        # passes, lane-partitioned broker) as the N-worker run it is
        # compared against.
        self.lane_mode = (
            self.num_batch_workers > 1 if lane_mode is None else bool(lane_mode)
        )
        # threshold/dwell overrides for the admission controller
        # (server/admission.py); None keeps the production defaults,
        # under which NORMAL behavior is identical to pre-admission.
        self.admission_overrides = admission_overrides
        # path to a persisted saturation-probe artifact (obs/calibrate.py
        # CALIB_r01.json): loaded into the server's calibration table at
        # startup, deriving the admission backlog thresholds from the
        # measured sustainable rate (source: probe). None = shipped
        # defaults.
        self.calibration_artifact = calibration_artifact
        # continuous defragmentation (server/defrag.py): periodic live
        # migration of allocs onto fewer nodes, bounded moves per cycle.
        # <= 0 keeps the periodic scan off (explicit operator triggers
        # still work); budget caps moves per cycle.
        self.defrag_interval = defrag_interval
        self.defrag_budget = defrag_budget


class Server:
    def __init__(self, config: Optional[ServerConfig] = None):
        self.config = config or ServerConfig()
        self.store = StateStore()
        clock = self.config.clock
        # Deterministic lane ownership (server/lanes.py): active only
        # with >1 batching worker. The broker then partitions by LANE
        # (num_lanes sub-queues, same crc32 job hash as LaneMap) so the
        # partitioned dequeue IS lane-affine routing; at one batching
        # worker everything stays on the legacy single-queue path,
        # bit-identical to r5 behavior.
        from .lanes import LaneClaims, LaneMap

        self.lane_mode = self.config.lane_mode
        self.lanes = LaneMap(
            num_lanes=self.config.num_lanes,
            num_batch_workers=self.config.num_batch_workers,
        )
        self.eval_broker = EvalBroker(
            n_partitions=self.lanes.num_lanes if self.lane_mode else 1,
            clock=clock.time if clock is not None else None,
        )
        self.blocked_evals = BlockedEvals(broker=self.eval_broker)
        # overload protection (server/admission.py): one controller per
        # server, fed by the broker's own depth/ack counters and the
        # always-on eval-latency histogram; handed to the broker so its
        # enqueue gate can defer over-watermark external evals.
        from .admission import AdmissionController, HistWindow

        # calibration plane (obs/calibrate.py): a per-server table
        # derives the admission defaults; a configured probe artifact
        # rewrites the backlog thresholds with source: probe before the
        # controller is built. The throughput estimator is the
        # PROCESS-global one (the learned-mode kernels read it),
        # refcount-attached to the flight recorder for the server's
        # lifetime.
        from ..obs.calibrate import CalibrationTable, global_estimator

        self.calibration = CalibrationTable()
        if self.config.calibration_artifact:
            self.calibration.load_probe_artifact(self.config.calibration_artifact)
        self.throughput_estimator = global_estimator
        self.throughput_estimator.attach()
        admission_cfg = self.calibration.admission_overrides()
        admission_cfg.update(self.config.admission_overrides or {})
        self.admission = AdmissionController(
            clock=clock.monotonic if clock is not None else None,
            depth_fn=self.eval_broker.queue_depths,
            p99_window=HistWindow(
                clock=clock.monotonic if clock is not None else None
            ),
            completions_fn=lambda: self.eval_broker.counters["acks"],
            **admission_cfg,
        )
        self.eval_broker.admission = self.admission
        self.plan_queue = PlanQueue()
        self.plan_apply_loop = PlanApplyLoop(
            self.store, self.plan_queue,
            on_evals_created=self.eval_broker.enqueue_all,
            commit=self._commit_plan_result,
            commit_merged=self._commit_merged_plan_result,
            lanes=self.lanes if self.lane_mode else None,
            token_check=self._plan_token_current,
        )
        self.workers: list[Worker] = []
        # resident device tensors shared by all workers, refreshed
        # incrementally by state index (SURVEY.md §7 'latency floor')
        from ..device.cache import DeviceStateCache

        self.device_cache = DeviceStateCache(self.config.device)
        # per-worker epoch overlays for pipelined batched passes
        # (server/overlay.py). In lane mode each batching worker owns
        # its own overlay — no shared mutable optimistic state; at one
        # batching worker the container delegates to a single overlay,
        # preserving the legacy shared behavior bit-for-bit.
        from .overlay import LaneOverlays

        self.placement_overlay = LaneOverlays(self.config.num_batch_workers)
        # cross-lane handoff table (reserve → confirm → release)
        self.lane_claims = LaneClaims(
            self.lanes,
            overlays=self.placement_overlay,
            snapshot_fn=self.store.snapshot,
        )
        self._raft_lock = threading.Lock()
        self._leader = False
        from ..broker.event_broker import EventBroker as StreamBroker
        from .core_gc import CoreScheduler
        from .deployment_watcher import DeploymentWatcher
        from .drainer import NodeDrainer
        from .heartbeat import NodeHeartbeater
        from .periodic import PeriodicDispatch

        self.drainer = NodeDrainer(self)
        from .defrag import DefragController

        # plans on self.config.device: the migration kernel on a CUDA
        # server, its plain version on a CPU one
        self.defrag = DefragController(
            self,
            interval=self.config.defrag_interval,
            budget=self.config.defrag_budget,
        )
        self.heartbeater = NodeHeartbeater(
            self,
            ttl=self.config.heartbeat_ttl,
            clock=clock.monotonic if clock is not None else None,
        )
        self.deployment_watcher = DeploymentWatcher(
            self, interval=self.config.deployment_watch_interval
        )
        self.periodic = PeriodicDispatch(self)
        self.core_gc = CoreScheduler(self)
        from .volume_watcher import VolumeWatcher

        self.volume_watcher = VolumeWatcher(self)
        self.events = StreamBroker()
        from .acl import ACLService

        self.acl = ACLService(self)
        # capacity changes unblock blocked evals (blocked_evals.go:55)
        self.store.add_listener(self._on_state_change)
        # the raft seam: FSM messages through InlineRaft (single server;
        # WAL-durable when data_dir is set). A consensus RaftNode swaps in
        # via attach_raft() for clustered servers.
        from ..raft import InlineRaft
        from ..state.snapshot import restore_snapshot, save_snapshot
        from .fsm import FSM, MsgType

        self._msg = MsgType
        self.fsm = FSM(lambda: self.store)
        self.raft = InlineRaft(
            self.fsm,
            data_dir=self.config.data_dir,
            snapshot_fn=lambda path: save_snapshot(self.store, path),
            restore_fn=lambda path: self._install_store(restore_snapshot(path)),
        )
        if self.config.data_dir:
            self.raft.restore()

    def _install_store(self, store) -> int:
        """Swap in a restored StateStore (snapshot restore / install)."""
        self.store = store
        self.plan_apply_loop.applier.store = store
        store.add_listener(self._on_state_change)
        # the restored store has a fresh journal that never names entities
        # deleted across the swap — resident tensors must rebuild
        self.device_cache.invalidate()
        return store.latest_index

    def attach_raft(self, raft) -> None:
        """Replace the inline seam with a consensus RaftNode (cluster)."""
        self.raft = raft

    @classmethod
    def from_snapshot(cls, path: str, config: Optional[ServerConfig] = None):
        """Boot a server from a saved state snapshot (the restore half of
        checkpoint/resume; nomadFSM.Restore + leader queue restoration)."""
        from ..state.snapshot import restore_snapshot

        server = cls(config)
        server._install_store(restore_snapshot(path))
        return server

    # -- API: namespaces (nomad/namespace_endpoint.go) ---------------------
    def upsert_namespace(self, ns) -> None:
        if not ns.name or not ns.name.replace("-", "").replace("_", "").isalnum():
            raise ValueError(f"invalid namespace name {ns.name!r}")
        self.raft_apply_checked(
            self._msg.NAMESPACE_UPSERT, {"namespace": ns}
        )

    def delete_namespace(self, name: str) -> None:
        self.raft_apply_checked(self._msg.NAMESPACE_DELETE, {"name": name})

    # -- API: scaling (nomad/job_endpoint.go Scale + scaling_endpoint.go) --
    def scale_job(self, namespace: str, job_id: str, group: str,
                  count: int, message: str = "", error: bool = False):
        """Job.Scale: adjust one group's count (a new job version) and
        record a scaling event; autoscalers drive this endpoint."""
        import copy as _copy

        job = self.store.job_by_id(namespace, job_id)
        if job is None:
            raise KeyError(f"job not found: {job_id}")
        tg = job.lookup_task_group(group)
        if tg is None:
            raise KeyError(f"group not found: {group}")
        from ..structs.evaluation import TRIGGER_JOB_SCALING
        from .admission import job_cost_demand

        self.admission.check_intake(
            job.priority, TRIGGER_JOB_SCALING,
            cost_demand=job_cost_demand(job),
        )
        if tg.scaling is not None and tg.scaling.enabled:
            if count < tg.scaling.min or (
                tg.scaling.max and count > tg.scaling.max
            ):
                raise ValueError(
                    f"count {count} outside scaling bounds "
                    f"[{tg.scaling.min}, {tg.scaling.max}]"
                )
        scaled = _copy.deepcopy(job)
        scaled.lookup_task_group(group).count = count
        ev = Evaluation(
            namespace=namespace,
            priority=job.priority,
            type=job.type,
            triggered_by=TRIGGER_JOB_REGISTER,
            job_id=job_id,
            status=EVAL_STATUS_PENDING,
        )
        event = {
            "group": group, "count": count, "previous_count": tg.count,
            "message": message, "error": error,
        }
        self.raft_apply(
            self._msg.JOB_SCALE,
            {"job": scaled, "evals": [ev], "event": event},
        )
        (ev,) = self._fresh_evals([ev])
        self.eval_broker.enqueue(ev)
        self._publish(
            "Job", "JobScaled", job_id, namespace,
            {"group": group, "count": count},
        )
        return ev

    def _plan_token_current(self, eval_id: str, token: str) -> bool:
        """Is ``token`` still the eval's outstanding broker token? Used
        by the plan applier to drop plans from workers whose eval was
        redelivered out from under them (unack-deadline expiry) — the
        reference's plan-submission token validation."""
        return self.eval_broker.outstanding_token(eval_id) == token

    def _commit_plan_result(self, result, eval_id, evals) -> int:
        index, _ = self.raft_apply(
            self._msg.PLAN_RESULT,
            {"result": result, "eval_id": eval_id, "evals": evals},
        )
        return index

    def _commit_merged_plan_result(self, results, eval_ids, evals) -> int:
        """One batched pass's member results land as ONE log entry — the
        merged-commit analog of _commit_plan_result."""
        index, _ = self.raft_apply(
            self._msg.MERGED_PLAN_RESULT,
            {"results": results, "eval_ids": eval_ids, "evals": evals},
        )
        return index

    def _fresh_evals(self, evals):
        """Re-read evals from the store after a raft commit: with a real
        consensus group the FSM applies unpickled COPIES, so the submitted
        objects lack the committed modify_index the worker's
        snapshot-min-index wait (worker.py:88) depends on."""
        out = []
        for ev in evals:
            out.append(self.store.eval_by_id(ev.id) or ev)
        return out

    # -- raft seam ---------------------------------------------------------
    def raft_apply(self, mtype, payload=None):
        """Submit one FSM message through the raft seam; returns
        (index, applier_result). Raises NotLeaderError on a follower —
        the RPC layer forwards to the leader (nomad/rpc.go forward())."""
        return self.raft.apply(mtype, payload)

    def raft_apply_checked(self, mtype, payload=None):
        """raft_apply for user-facing endpoints: a rejection the FSM
        returned as a result (appliers never raise) is re-raised here, on
        the submitting server only."""
        index, result = self.raft.apply(mtype, payload)
        if isinstance(result, Exception):
            raise result
        return index, result

    # -- leadership --------------------------------------------------------
    def establish_leadership(self) -> None:
        """leader.go:230-347."""
        self._leader = True
        self.plan_queue.set_enabled(True)
        self.plan_apply_loop.start()
        self.eval_broker.set_enabled(True)
        self.blocked_evals.set_enabled(True)
        self.heartbeater.initialize_from_store()
        self.heartbeater.start()
        self.deployment_watcher.start()
        self.drainer.start()
        self.defrag.start()
        self.periodic.restore()
        self.periodic.start()
        self.core_gc.start()
        self.volume_watcher.start()
        self._restore_evals()
        for i in range(self.config.num_workers):
            w = Worker(self, worker_id=i)
            self.workers.append(w)
            w.start()

    def revoke_leadership(self) -> None:
        for w in self.workers:
            w.stop()
        self.workers.clear()
        self.heartbeater.stop()
        self.deployment_watcher.stop()
        self.drainer.stop()
        self.defrag.stop()
        self.periodic.stop()
        self.core_gc.stop()
        self.volume_watcher.stop()
        self.plan_apply_loop.stop()
        self.plan_queue.set_enabled(False)
        self.eval_broker.set_enabled(False)
        self.blocked_evals.set_enabled(False)
        self._leader = False

    def shutdown(self) -> None:
        if self._leader:
            self.revoke_leadership()
        # release this server's hold on the process-global estimator
        # (refcounted; the listener detaches with the last server)
        est = getattr(self, "throughput_estimator", None)
        if est is not None:
            est.detach()
            self.throughput_estimator = None
        # flush + release the durable log (InlineRaft.close is idempotent;
        # a consensus RaftNode is owned and closed by its ClusterServer)
        close = getattr(self.raft, "close", None)
        if close is not None:
            close()

    def _restore_evals(self) -> None:
        """Re-populate broker/blocked from durable state on leadership
        (leader.go:269 restoreEvals)."""
        for ev in self.store.evals():
            if ev.should_enqueue():
                self.eval_broker.enqueue(ev)
            elif ev.should_block():
                self.blocked_evals.block(ev)

    # -- API: jobs ---------------------------------------------------------
    def register_job(self, job: Job) -> Evaluation:
        """Job.Register (nomad/job_endpoint.go): upsert job + create eval
        in one commit, then enqueue."""
        validate_job(job)
        # overload gate BEFORE any state commit: a shed register raises
        # AdmissionRejected (HTTP: 429 + Retry-After) with nothing
        # written, so job/eval conservation laws never see it
        from .admission import job_cost_demand

        self.admission.check_intake(
            job.priority, TRIGGER_JOB_REGISTER,
            cost_demand=job_cost_demand(job),
        )
        # periodic/parameterized jobs are templates: no eval until a child
        # is derived (job_endpoint.go Register skips eval creation for them)
        needs_eval = not job.is_periodic() and not job.is_parameterized()
        ev = Evaluation(
            namespace=job.namespace,
            priority=job.priority,
            type=job.type,
            triggered_by=TRIGGER_JOB_REGISTER,
            job_id=job.id,
            status=EVAL_STATUS_PENDING,
        )

        self.raft_apply(
            self._msg.JOB_UPSERT,
            {"job": job, "evals": [ev] if needs_eval else []},
        )
        self.blocked_evals.untrack(job.namespace, job.id)
        self._publish(
            "Job", "JobRegistered", job.id, job.namespace, {"job_id": job.id}
        )
        if job.is_periodic():
            self.periodic.add(job)
        if needs_eval:
            (ev,) = self._fresh_evals([ev])
            self.eval_broker.enqueue(ev)
        return ev

    def dispatch_job(
        self, namespace: str, job_id: str, payload: bytes = b"", meta=None
    ):
        """Dispatch a parameterized job: derive a one-shot child
        (nomad/job_endpoint.go Job.Dispatch)."""
        import copy as _copy
        import time as _t

        parent = self.store.job_by_id(namespace, job_id)
        if parent is None or not parent.is_parameterized():
            raise ValueError(f"job {job_id} is not parameterized")
        cfg = parent.parameterized
        meta = dict(meta or {})
        missing = [k for k in cfg.meta_required if k not in meta]
        if missing:
            raise ValueError(f"missing required dispatch meta: {missing}")
        unknown = [
            k
            for k in meta
            if k not in cfg.meta_required and k not in cfg.meta_optional
        ]
        if unknown:
            raise ValueError(f"dispatch meta not allowed: {unknown}")
        if cfg.payload == "required" and not payload:
            raise ValueError("dispatch payload is required")
        if cfg.payload == "forbidden" and payload:
            raise ValueError("dispatch payload is forbidden")
        child = _copy.deepcopy(parent)
        child.id = f"{parent.id}/dispatch-{int(_t.time())}-{new_id()[:8]}"
        child.name = child.id
        child.parameterized = None
        child.parent_id = parent.id
        child.payload = payload
        child.meta = {**parent.meta, **meta}
        ev = self.register_job(child)
        return child, ev

    def deregister_job(self, namespace: str, job_id: str) -> Optional[Evaluation]:
        job = self.store.job_by_id(namespace, job_id)
        if job is None:
            return None
        import copy

        stopped = copy.deepcopy(job)
        stopped.stop = True
        ev = Evaluation(
            namespace=namespace,
            priority=job.priority,
            type=job.type,
            triggered_by=TRIGGER_JOB_DEREGISTER,
            job_id=job_id,
            status=EVAL_STATUS_PENDING,
        )

        self.raft_apply(self._msg.JOB_UPSERT, {"job": stopped, "evals": [ev]})
        self.blocked_evals.untrack(namespace, job_id)
        self.periodic.remove(namespace, job_id)
        self._publish(
            "Job", "JobDeregistered", job_id, namespace, {"job_id": job_id}
        )
        (ev,) = self._fresh_evals([ev])
        self.eval_broker.enqueue(ev)
        return ev

    # -- API: nodes --------------------------------------------------------
    def register_node(self, node: Node) -> None:
        self.raft_apply(self._msg.NODE_UPSERT, {"node": node})
        self._publish(
            "Node", "NodeRegistration", node.id, "default", {"node_id": node.id}
        )

    def update_node_status(self, node_id: str, status: str) -> list[Evaluation]:
        """Node.UpdateStatus: commit + fan out node-update evals for every
        job with allocs on the node (nomad/node_endpoint.go createNodeEvals)."""
        self.raft_apply(
            self._msg.NODE_STATUS, {"node_id": node_id, "status": status}
        )
        self._publish(
            "Node", "NodeStatusUpdate", node_id, "default", {"status": status}
        )
        return self._create_node_evals(node_id)

    def update_node_drain(self, node_id: str, drain) -> list[Evaluation]:
        """Node.UpdateDrain: stamp the force deadline and commit; the
        NodeDrainer picks the node up on its next scan. Cancelling a
        drain clears any pending migrate marks so wave accounting and
        future drains start clean (drainer.go Remove)."""
        import time as _t

        if drain is not None and drain.deadline_s > 0 and not drain.force_deadline_unix:
            drain.force_deadline_unix = _t.time() + drain.deadline_s

        resets = {}
        if drain is None:
            from ..structs.alloc import DesiredTransition as _DT

            for a in self.store.allocs_by_node(node_id):
                if not a.terminal_status() and a.desired_transition.migrate:
                    resets[a.id] = _DT(migrate=False)

        self.raft_apply(
            self._msg.NODE_DRAIN,
            {"node_id": node_id, "drain": drain, "transitions": resets},
        )
        return self._create_node_evals(node_id)

    def stop_alloc(self, alloc_id: str) -> Optional[Evaluation]:
        """Alloc.Stop (nomad/alloc_endpoint.go): mark the allocation for
        migration and evaluate its job — the reconciler replaces it on
        another node. Returns the eval (None if the alloc is unknown or
        already terminal)."""
        from ..structs.alloc import DesiredTransition as _DT
        from ..structs.evaluation import (
            EVAL_STATUS_PENDING,
            TRIGGER_ALLOC_STOP,
        )

        alloc = self.store.alloc_by_id(alloc_id)
        if alloc is None or alloc.terminal_status():
            return None
        job = self.store.job_by_id(alloc.namespace, alloc.job_id)
        ev = Evaluation(
            namespace=alloc.namespace,
            priority=job.priority if job else 50,
            type=job.type if job else "service",
            triggered_by=TRIGGER_ALLOC_STOP,
            job_id=alloc.job_id,
            status=EVAL_STATUS_PENDING,
        )
        self.raft_apply(
            self._msg.ALLOC_DESIRED_TRANSITION,
            {
                "transitions": {alloc_id: _DT(migrate=True)},
                "evals": [ev],
            },
        )
        (ev,) = self._fresh_evals([ev])
        self.eval_broker.enqueue(ev)
        return ev

    def _create_node_evals(self, node_id: str) -> list[Evaluation]:
        jobs = {}
        for a in self.store.allocs_by_node(node_id):
            if not a.terminal_status() or a.client_status == "failed":
                jobs[(a.namespace, a.job_id)] = a
        evals = []
        for (ns, job_id), a in jobs.items():
            job = self.store.job_by_id(ns, job_id)
            evals.append(
                Evaluation(
                    namespace=ns,
                    priority=job.priority if job else 50,
                    type=job.type if job else "service",
                    triggered_by=TRIGGER_NODE_UPDATE,
                    job_id=job_id,
                    node_id=node_id,
                    status=EVAL_STATUS_PENDING,
                )
            )
        # system jobs must also react to new/changed nodes
        node = self.store.node_by_id(node_id)
        if node is not None and node.ready():
            for job in self.store.jobs():
                if job.type in ("system", "sysbatch") and not job.stopped():
                    evals.append(
                        Evaluation(
                            namespace=job.namespace,
                            priority=job.priority,
                            type=job.type,
                            triggered_by=TRIGGER_NODE_UPDATE,
                            job_id=job.id,
                            node_id=node_id,
                            status=EVAL_STATUS_PENDING,
                        )
                    )
        if evals:
            self.raft_apply(self._msg.EVAL_UPSERT, {"evals": evals})
            evals = self._fresh_evals(evals)
            self.eval_broker.enqueue_all(evals)
        return evals

    # -- API: client alloc updates ----------------------------------------
    # -- CSI volumes (csi_endpoint.go Register/Deregister/Claim) -----------
    def register_csi_volume(self, vol) -> None:
        self.raft_apply_checked(self._msg.CSI_VOLUME_UPSERT, {"volume": vol})

    def deregister_csi_volume(self, volume_id: str, force: bool = False) -> None:
        self.raft_apply_checked(
            self._msg.CSI_VOLUME_DEREGISTER,
            {"volume_id": volume_id, "force": force},
        )

    def claim_csi_volume(
        self, volume_id: str, alloc_id: str, node_id: str, read_only: bool
    ) -> bool:
        """Client-initiated claim (CSIVolume.Claim RPC) — plan apply claims
        eagerly, so this is for external/API claimants. Claims whose id is
        not a live alloc are marked external so the volume watcher never
        reaps them as "alloc gone"."""
        _i, ok = self.raft_apply(
            self._msg.CSI_CLAIM,
            {
                "volume_id": volume_id, "claim_id": alloc_id,
                "node_id": node_id, "read_only": read_only,
            },
        )
        return bool(ok)

    def update_allocs_from_client(self, updates: Iterable[Allocation]) -> None:
        updates = list(updates)
        self.raft_apply(self._msg.ALLOC_CLIENT_UPDATE, {"updates": updates})
        for u in updates:
            self._publish(
                "Allocation",
                "AllocationClientUpdated",
                u.id,
                u.namespace,
                {"client_status": u.client_status, "job_id": u.job_id},
            )
        # terminal client statuses free capacity ⇒ unblock held evals
        if any(
            u.client_status in ("complete", "failed", "lost") for u in updates
        ):
            self.blocked_evals.unblock(index=self.store.latest_index)
        # failed allocs trigger reschedule evals (node_endpoint.go)
        evals = []
        seen = set()
        for upd in updates:
            if upd.client_status != "failed":
                continue
            a = self.store.alloc_by_id(upd.id)
            if a is None or (a.namespace, a.job_id) in seen:
                continue
            seen.add((a.namespace, a.job_id))
            job = self.store.job_by_id(a.namespace, a.job_id)
            if job is None or job.stopped():
                continue
            evals.append(
                Evaluation(
                    namespace=a.namespace,
                    priority=job.priority,
                    type=job.type,
                    triggered_by=TRIGGER_RETRY_FAILED_ALLOC,
                    job_id=a.job_id,
                    status=EVAL_STATUS_PENDING,
                )
            )
        if evals:
            self.raft_apply(self._msg.EVAL_UPSERT, {"evals": evals})
            self.eval_broker.enqueue_all(self._fresh_evals(evals))

    # -- eval lifecycle (worker callbacks) ---------------------------------
    def apply_eval_update(self, evals: list[Evaluation]) -> None:
        self.raft_apply(self._msg.EVAL_UPSERT, {"evals": evals})
        for ev in self._fresh_evals(evals):
            if ev.status == EVAL_STATUS_BLOCKED:
                self.blocked_evals.block(ev)

    def apply_eval_create(self, evals: list[Evaluation]) -> None:
        self.raft_apply(self._msg.EVAL_UPSERT, {"evals": evals})
        for ev in self._fresh_evals(evals):
            if ev.status == EVAL_STATUS_BLOCKED:
                self.blocked_evals.block(ev)
            elif ev.wait_until_unix:
                self.eval_broker.enqueue(ev)
            elif ev.should_enqueue():
                self.eval_broker.enqueue(ev)

    # -- state-change fan-out ----------------------------------------------
    def _on_state_change(self, table: str, index: int) -> None:
        if table == "nodes":
            # capacity may have appeared: unblock everything eligible
            self.blocked_evals.unblock(index=index)

    def _publish(
        self, topic: str, type_: str, key: str, namespace: str, payload: dict
    ) -> None:
        from ..broker.event_broker import Event

        self.events.publish(
            [Event(topic=topic, type=type_, key=key, namespace=namespace, payload=payload)],
            self.store.latest_index,
        )

    # -- client RPC seam ---------------------------------------------------
    def client_rpc(self) -> "InProcessClientRPC":
        return InProcessClientRPC(self)

    def pull_allocs(
        self, node_id: str, min_index: int, timeout: float = 1.0
    ) -> tuple[list[Allocation], int]:
        """Blocking query: the client's alloc pull (node_endpoint.go
        Node.GetClientAllocs semantics — return once state moves past the
        client's known index, or on timeout)."""
        if self.store.latest_index <= min_index:
            self.store.wait_for_index(min_index + 1, timeout=timeout)
        return self.store.allocs_by_node(node_id), self.store.latest_index

    # -- convenience -------------------------------------------------------
    def wait_for_evals(self, timeout: float = 10.0) -> bool:
        """Test/ops helper: wait until no ready or in-flight evals remain."""
        import time

        deadline = time.time() + timeout
        while time.time() < deadline:
            with self.eval_broker._lock:
                busy = (
                    self.eval_broker.ready_count()
                    + len(self.eval_broker._unack)
                    + len(self.eval_broker._delayed)
                )
            if busy == 0 and self.plan_queue.depth() == 0:
                return True
            time.sleep(0.01)
        return False


class InProcessClientRPC:
    """The client↔server transport seam, in-process flavor (the reference's
    msgpack-RPC client/rpc.go collapses to method calls for the dev agent)."""

    def __init__(self, server: Server):
        self.server = server

    def register_node(self, node) -> None:
        self.server.register_node(node)
        self.server.heartbeater.heartbeat(node.id)

    def heartbeat(self, node_id: str) -> float:
        node = self.server.store.node_by_id(node_id)
        if node is not None and node.status == "down":
            # node recovered after missed TTLs (heartbeat.go resurrection)
            self.server.update_node_status(node_id, "ready")
        return self.server.heartbeater.heartbeat(node_id)

    def pull_allocs(self, node_id: str, min_index: int, timeout: float):
        return self.server.pull_allocs(node_id, min_index, timeout)

    def update_allocs(self, updates) -> None:
        self.server.update_allocs_from_client(updates)

    def csi_volume_info(self, volume_id: str):
        """(resolved_volume_id, plugin_id) or None — the client's volume
        resolver for CSI publish routing (CSIVolume.Get's role). The
        caller may pass a per-alloc id (``source[idx]``); resolution
        falls back to the base source exactly like the scheduler and the
        plan applier do."""
        store = self.server.store
        vol = store.csi_volume_by_id(volume_id)
        if vol is None and "[" in volume_id:
            base = volume_id.split("[", 1)[0]
            vol = store.csi_volume_by_id(base)
        if vol is None:
            return None
        return vol.id, vol.plugin_id
