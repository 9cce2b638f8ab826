"""HTTP API agent.

Reference: command/agent/http.go (:275-360 route table). The `/v1/...`
REST surface over the server, stdlib-only (ThreadingHTTPServer): jobs
(register/list/read/plan/evals/allocs/deregister), nodes (list/read/
drain/eligibility), allocations, evaluations, operator scheduler config
(the seam the TPU algorithm is toggled through,
nomad/structs/operator.go:128-169), agent self, and metrics.

Blocking queries: ``?index=N&wait=S`` holds the request until the state
store passes index N (the memdb WatchSet analog, state_store.go blocking
queries); every response carries ``X-Nomad-Index``.
"""

from __future__ import annotations

import json
import re
import threading
import uuid
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

from ..server.admission import AdmissionRejected
from ..server.fsm import MsgType
from ..structs import Evaluation, new_id
from ..structs.job import JOB_DEFAULT_PRIORITY
from .codec import _decode_into, decode_job, encode


class APIError(Exception):
    def __init__(self, status: int, message: str, headers: Optional[dict] = None):
        super().__init__(message)
        self.status = status
        self.message = message
        self.headers = headers


class StreamingResponse:
    """Marker for NDJSON streaming handlers (/v1/event/stream)."""

    def __init__(self, iterator):
        self.iterator = iterator


class HTTPAgent:
    """Routes + handlers bound to a Server (and optionally a Client)."""

    def __init__(self, server, client=None, host="127.0.0.1", port=4646):
        self.server = server
        self.client = client
        self.host = host
        self.port = port
        self._httpd: Optional[ThreadingHTTPServer] = None
        self._thread: Optional[threading.Thread] = None
        self.routes = [
            (re.compile(r"^/v1/jobs$"), self.handle_jobs),
            (re.compile(r"^/v1/job/(?P<job_id>[^/]+)$"), self.handle_job),
            (re.compile(r"^/v1/job/(?P<job_id>[^/]+)/plan$"), self.handle_job_plan),
            (
                re.compile(r"^/v1/job/(?P<job_id>[^/]+)/evaluations$"),
                self.handle_job_evals,
            ),
            (
                re.compile(r"^/v1/job/(?P<job_id>[^/]+)/allocations$"),
                self.handle_job_allocs,
            ),
            (
                re.compile(r"^/v1/job/(?P<job_id>[^/]+)/summary$"),
                self.handle_job_summary,
            ),
            (re.compile(r"^/v1/nodes$"), self.handle_nodes),
            (re.compile(r"^/v1/node/(?P<node_id>[^/]+)$"), self.handle_node),
            (
                re.compile(r"^/v1/node/(?P<node_id>[^/]+)/drain$"),
                self.handle_node_drain,
            ),
            (
                re.compile(r"^/v1/node/(?P<node_id>[^/]+)/eligibility$"),
                self.handle_node_eligibility,
            ),
            (
                re.compile(r"^/v1/node/(?P<node_id>[^/]+)/allocations$"),
                self.handle_node_allocs,
            ),
            (
                re.compile(r"^/v1/job/(?P<job_id>[^/]+)/deployments$"),
                self.handle_job_deployments,
            ),
            (re.compile(r"^/v1/deployments$"), self.handle_deployments),
            (
                re.compile(r"^/v1/deployment/promote/(?P<deployment_id>[^/]+)$"),
                self.handle_deployment_promote,
            ),
            (
                re.compile(r"^/v1/deployment/fail/(?P<deployment_id>[^/]+)$"),
                self.handle_deployment_fail,
            ),
            (
                re.compile(r"^/v1/deployment/pause/(?P<deployment_id>[^/]+)$"),
                self.handle_deployment_pause,
            ),
            (
                re.compile(r"^/v1/deployment/(?P<deployment_id>[^/]+)$"),
                self.handle_deployment,
            ),
            (re.compile(r"^/v1/volumes$"), self.handle_volumes),
            (
                re.compile(r"^/v1/volume/csi/(?P<volume_id>[^/]+)$"),
                self.handle_volume,
            ),
            (re.compile(r"^/v1/plugins$"), self.handle_plugins),
            (re.compile(r"^/v1/allocations$"), self.handle_allocs),
            (
                re.compile(r"^/v1/allocation/(?P<alloc_id>[^/]+)/stop$"),
                self.handle_alloc_stop,
            ),
            (
                # score provenance: why this alloc landed where it did
                # (obs/explain.py; `nomad-tpu alloc why`)
                re.compile(
                    r"^/v1/allocations?/(?P<alloc_id>[^/]+)/explain$"
                ),
                self.handle_alloc_explain,
            ),
            (
                re.compile(r"^/v1/allocation/(?P<alloc_id>[^/]+)$"),
                self.handle_alloc,
            ),
            (re.compile(r"^/v1/evaluations$"), self.handle_evals),
            (
                # per-group placement explanation for one eval (the
                # flight recorder's explanation ring, obs/recorder.py)
                re.compile(
                    r"^/v1/evaluations?/(?P<eval_id>[^/]+)/placement$"
                ),
                self.handle_eval_placement,
            ),
            (
                re.compile(r"^/v1/evaluation/(?P<eval_id>[^/]+)$"),
                self.handle_eval,
            ),
            (
                re.compile(r"^/v1/operator/scheduler/configuration$"),
                self.handle_scheduler_config,
            ),
            (
                # heterogeneity observability: which device classes hold
                # which jobs' allocations (scheduler/hetero.py)
                re.compile(r"^/v1/operator/scheduler/placements$"),
                self.handle_hetero_placements,
            ),
            (
                # raft inspection (command/operator_raft_list.go,
                # nomad/operator_endpoint.go RaftGetConfiguration)
                re.compile(r"^/v1/operator/raft/configuration$"),
                self.handle_raft_configuration,
            ),
            (
                # peer removal (command/operator_raft_remove.go,
                # operator_endpoint.go RaftRemovePeerByID)
                re.compile(r"^/v1/operator/raft/peer$"),
                self.handle_raft_peer,
            ),
            (
                # continuous-defrag control plane (server/defrag.py):
                # GET status/counters, POST an immediate cycle
                re.compile(r"^/v1/operator/defrag$"),
                self.handle_operator_defrag,
            ),
            (
                re.compile(r"^/v1/job/(?P<job_id>[^/]+)/dispatch$"),
                self.handle_job_dispatch,
            ),
            (
                # version history (job_endpoint.go GetJobVersions)
                re.compile(r"^/v1/job/(?P<job_id>[^/]+)/versions$"),
                self.handle_job_versions,
            ),
            (
                # rollback to a prior version (job_endpoint.go Revert)
                re.compile(r"^/v1/job/(?P<job_id>[^/]+)/revert$"),
                self.handle_job_revert,
            ),
            (
                # forced re-evaluation (job_endpoint.go Evaluate)
                re.compile(r"^/v1/job/(?P<job_id>[^/]+)/evaluate$"),
                self.handle_job_evaluate,
            ),
            (
                # manual GC sweep (system_endpoint.go GarbageCollect)
                re.compile(r"^/v1/system/gc$"),
                self.handle_system_gc,
            ),
            (
                re.compile(r"^/v1/job/(?P<job_id>[^/]+)/periodic/force$"),
                self.handle_periodic_force,
            ),
            (re.compile(r"^/v1/event/stream$"), self.handle_event_stream),
            (re.compile(r"^/v1/namespaces$"), self.handle_namespaces),
            (
                re.compile(r"^/v1/namespace/(?P<name>[^/]+)$"),
                self.handle_namespace,
            ),
            (re.compile(r"^/v1/namespace$"), self.handle_namespace_create),
            (
                re.compile(r"^/v1/job/(?P<job_id>[^/]+)/scale$"),
                self.handle_job_scale,
            ),
            (
                re.compile(r"^/v1/scaling/policies$"),
                self.handle_scaling_policies,
            ),
            (re.compile(r"^/v1/search$"), self.handle_search),
            (
                re.compile(r"^/v1/client/fs/ls/(?P<alloc_id>[^/]+)$"),
                self.handle_fs_ls,
            ),
            (
                re.compile(r"^/v1/client/fs/cat/(?P<alloc_id>[^/]+)$"),
                self.handle_fs_cat,
            ),
            (
                re.compile(r"^/v1/client/fs/logs/(?P<alloc_id>[^/]+)$"),
                self.handle_fs_logs,
            ),
            (
                re.compile(r"^/v1/operator/snapshot/save$"),
                self.handle_snapshot_save,
            ),
            (re.compile(r"^/v1/agent/self$"), self.handle_agent_self),
            (
                # pprof surface (command/agent/http.go:331)
                re.compile(r"^/v1/agent/pprof/(?P<kind>[^/]+)$"),
                self.handle_pprof,
            ),
            (
                # operator debug bundle (command/operator_debug.go:54)
                re.compile(r"^/v1/operator/debug$"),
                self.handle_operator_debug,
            ),
            (
                # flight-recorder surface: recent traces + error events
                re.compile(r"^/v1/agent/trace$"),
                self.handle_agent_trace,
            ),
            (
                re.compile(r"^/v1/agent/trace/(?P<eval_id>[^/]+)$"),
                self.handle_agent_trace,
            ),
            (
                # resilience surface: breaker states + recent trips
                re.compile(r"^/v1/agent/resilience$"),
                self.handle_agent_resilience,
            ),
            (
                # SLO surface: windowed latency percentiles + verdict
                re.compile(r"^/v1/agent/slo$"),
                self.handle_agent_slo,
            ),
            (
                # calibration surface: constant provenance + learned
                # throughput cells
                re.compile(r"^/v1/agent/calibration$"),
                self.handle_agent_calibration,
            ),
            (re.compile(r"^/v1/status/leader$"), self.handle_leader),
            (re.compile(r"^/v1/metrics$"), self.handle_metrics),
            (re.compile(r"^/v1/acl/bootstrap$"), self.handle_acl_bootstrap),
            (re.compile(r"^/v1/acl/policies$"), self.handle_acl_policies),
            (
                re.compile(r"^/v1/acl/policy/(?P<name>[^/]+)$"),
                self.handle_acl_policy,
            ),
            (re.compile(r"^/v1/acl/tokens$"), self.handle_acl_tokens),
            (re.compile(r"^/v1/acl/token$"), self.handle_acl_token_create),
            (re.compile(r"^/v1/acl/token/self$"), self.handle_acl_token_self),
            (
                re.compile(r"^/v1/acl/token/(?P<accessor>[^/]+)$"),
                self.handle_acl_token,
            ),
        ]

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        agent = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # silence
                pass

            def _dispatch(self, method):
                parsed = urlparse(self.path)
                query = {
                    k: v[0] for k, v in parse_qs(parsed.query).items()
                }
                # token: X-Nomad-Token header wins over ?token= (http.go
                # parseToken); stashed under a reserved key for handlers
                query["_secret"] = self.headers.get(
                    "X-Nomad-Token", query.get("token", "")
                )
                body = None
                length = int(self.headers.get("Content-Length") or 0)
                if length:
                    raw = self.rfile.read(length)
                    try:
                        body = json.loads(raw)
                    except json.JSONDecodeError:
                        self._reply(400, {"error": "invalid JSON body"})
                        return
                for pattern, handler in agent.routes:
                    m = pattern.match(parsed.path)
                    if m:
                        try:
                            result = handler(
                                method, body, query, **m.groupdict()
                            )
                        except APIError as e:
                            self._reply(
                                e.status, {"error": e.message}, headers=e.headers
                            )
                        except AdmissionRejected as e:
                            # overload: the controller refused the work
                            # before anything was committed — tell the
                            # client when to come back (RFC 6585)
                            self._reply(
                                429,
                                {
                                    "error": str(e),
                                    "admission_level": e.level,
                                    "retry_after": e.retry_after,
                                },
                                headers={"Retry-After": f"{e.retry_after:g}"},
                            )
                        except Exception as e:  # noqa: BLE001
                            self._reply(500, {"error": str(e)})
                        else:
                            if isinstance(result, StreamingResponse):
                                self._stream(result.iterator)
                            else:
                                self._reply(200, result)
                        return
                self._reply(404, {"error": f"no handler for {parsed.path}"})

            def _reply(self, status, payload, headers=None):
                data = json.dumps(payload).encode()
                self.send_response(status)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(data)))
                self.send_header(
                    "X-Nomad-Index", str(agent.server.store.latest_index)
                )
                for name, value in (headers or {}).items():
                    self.send_header(name, str(value))
                self.end_headers()
                self.wfile.write(data)

            def _stream(self, iterator):
                """NDJSON chunked streaming (nomad/stream/ndjson.go)."""
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Transfer-Encoding", "chunked")
                self.end_headers()

                def write_chunk(data: bytes):
                    self.wfile.write(f"{len(data):x}\r\n".encode())
                    self.wfile.write(data + b"\r\n")
                    self.wfile.flush()

                try:
                    for line in iterator:
                        write_chunk(line.encode() + b"\n")
                    self.wfile.write(b"0\r\n\r\n")
                except (BrokenPipeError, ConnectionResetError):
                    pass

            def do_GET(self):
                self._dispatch("GET")

            def do_POST(self):
                self._dispatch("POST")

            def do_PUT(self):
                self._dispatch("PUT")

            def do_DELETE(self):
                self._dispatch("DELETE")

        self._httpd = ThreadingHTTPServer((self.host, self.port), Handler)
        self.port = self._httpd.server_address[1]
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="http-agent", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        if self._httpd:
            self._httpd.shutdown()
            self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=2)

    @property
    def address(self) -> str:
        return f"http://{self.host}:{self.port}"

    # -- blocking-query helper --------------------------------------------
    def _maybe_block(self, query) -> None:
        index = int(query.get("index", 0) or 0)
        if index:
            wait = float(query.get("wait", 5.0) or 5.0)
            self.server.store.wait_for_index(index + 1, timeout=wait)

    # -- ACL enforcement ---------------------------------------------------
    def _acl(self, query):
        """Resolve the request token to a compiled ACL; None when ACLs are
        disabled (reference: agent http.go parseToken + srv.ResolveToken)."""
        from ..server.acl import TokenError

        try:
            return self.server.acl.resolve_token(query.get("_secret", ""))
        except TokenError as e:
            raise APIError(403, str(e)) from None

    def _enforce_ns(self, query, cap: str) -> None:
        acl = self._acl(query)
        ns = query.get("namespace", "default")
        if acl is not None and not acl.allow_namespace_operation(ns, cap):
            raise APIError(403, "Permission denied")

    def _enforce(self, query, check: str) -> None:
        """check: '<scope>_<read|write|list>' e.g. 'node_write'."""
        acl = self._acl(query)
        if acl is None:
            return
        if not getattr(acl, f"allow_{check}")():
            raise APIError(403, "Permission denied")

    def _enforce_management(self, query) -> None:
        acl = self._acl(query)
        if acl is not None and not acl.is_management():
            raise APIError(403, "Permission denied")

    def _enforce_obj_ns(self, query, namespace: str, cap: str) -> None:
        """Enforce against an object's OWN namespace (not the query param)
        — the reference resolves the object first, then checks its
        namespace (e.g. deployment_endpoint.go)."""
        acl = self._acl(query)
        if acl is not None and not acl.allow_namespace_operation(namespace, cap):
            raise APIError(403, "Permission denied")

    def _ns_filter(self, query, cap: str):
        """Returns a predicate filtering objects to namespaces the token
        can see (list endpoints must not leak other namespaces)."""
        acl = self._acl(query)
        if acl is None:
            return lambda ns: True
        return lambda ns: acl.allow_namespace_operation(ns, cap)

    # -- handlers ----------------------------------------------------------
    def handle_jobs(self, method, body, query):
        if method == "GET":
            self._enforce_ns(query, "list-jobs")
            visible = self._ns_filter(query, "list-jobs")
            self._maybe_block(query)
            return [
                {
                    "id": j.id,
                    "name": j.name,
                    "namespace": j.namespace,
                    "type": j.type,
                    "priority": j.priority,
                    "status": j.status,
                    "stop": j.stop,
                    "version": j.version,
                    "modify_index": j.modify_index,
                }
                for j in self.server.store.jobs()
                if visible(j.namespace)
            ]
        if method in ("POST", "PUT"):
            payload = body.get("job") if isinstance(body, dict) else None
            if payload is None:
                raise APIError(400, "missing 'job' in body")
            job = decode_job(payload)
            self._enforce_obj_ns(query, job.namespace or "default", "submit-job")
            if not job.id:
                raise APIError(400, "job id is required")
            if not job.task_groups:
                raise APIError(400, "job needs at least one task group")
            job.priority = job.priority or JOB_DEFAULT_PRIORITY
            try:
                ev = self.server.register_job(job)
            except ValueError as e:  # JobValidationError
                raise APIError(400, str(e)) from None
            return {"eval_id": ev.id, "job_modify_index": job.modify_index}
        raise APIError(405, f"method {method} not allowed")

    def _get_job(self, job_id, query):
        ns = query.get("namespace", "default")
        job = self.server.store.job_by_id(ns, job_id)
        if job is None:
            raise APIError(404, f"job {job_id} not found")
        return job

    def handle_job(self, method, body, query, job_id):
        if method == "GET":
            self._enforce_ns(query, "read-job")
            self._maybe_block(query)
            return encode(self._get_job(job_id, query))
        if method == "DELETE":
            self._enforce_ns(query, "submit-job")
            job = self._get_job(job_id, query)
            ev = self.server.deregister_job(job.namespace, job.id)
            return {"eval_id": ev.id if ev else ""}
        raise APIError(405, f"method {method} not allowed")

    def handle_job_plan(self, method, body, query, job_id):
        """Dry-run: run the scheduler inline on a snapshot without
        submitting the plan (SURVEY.md §3.3, nomad/job_endpoint Job.Plan)."""
        if method not in ("POST", "PUT"):
            raise APIError(405, "POST required")
        payload = body.get("job") if isinstance(body, dict) else None
        if payload is None:
            raise APIError(400, "missing 'job' in body")
        job = decode_job(payload)
        self._enforce_obj_ns(query, job.namespace or "default", "submit-job")
        from ..scheduler.annotate import plan_job

        return plan_job(self.server.store, job, device=self.server.config.device)

    def handle_job_evals(self, method, body, query, job_id):
        self._enforce_ns(query, "read-job")
        job = self._get_job(job_id, query)
        return [encode(e) for e in self.server.store.evals_by_job(job.namespace, job.id)]

    def handle_job_allocs(self, method, body, query, job_id):
        self._enforce_ns(query, "read-job")
        job = self._get_job(job_id, query)
        self._maybe_block(query)
        return [
            encode(a)
            for a in self.server.store.allocs_by_job(job.namespace, job.id)
        ]

    def handle_job_summary(self, method, body, query, job_id):
        self._enforce_ns(query, "read-job")
        job = self._get_job(job_id, query)
        allocs = self.server.store.allocs_by_job(job.namespace, job.id)
        summary: dict[str, dict[str, int]] = {}
        for tg in job.task_groups:
            summary[tg.name] = {
                "queued": 0, "starting": 0, "running": 0,
                "complete": 0, "failed": 0, "lost": 0,
            }
        for a in allocs:
            s = summary.setdefault(a.task_group, {})
            key = {
                "pending": "starting",
                "running": "running",
                "complete": "complete",
                "failed": "failed",
                "lost": "lost",
            }.get(a.client_status, "starting")
            if a.desired_status == "run" or a.client_terminal_status():
                s[key] = s.get(key, 0) + 1
        for ev in self.server.store.evals_by_job(job.namespace, job.id):
            for tg, n in ev.queued_allocations.items():
                if tg in summary:
                    summary[tg]["queued"] = max(summary[tg]["queued"], n)
        return {"job_id": job.id, "summary": summary}

    def handle_job_deployments(self, method, body, query, job_id):
        self._enforce_ns(query, "read-job")
        job = self._get_job(job_id, query)
        return [
            encode(d)
            for d in self.server.store.deployments()
            if d.job_id == job.id and d.namespace == job.namespace
        ]

    def handle_deployments(self, method, body, query):
        self._enforce_ns(query, "read-job")
        visible = self._ns_filter(query, "read-job")
        self._maybe_block(query)
        return [
            encode(d)
            for d in self.server.store.deployments()
            if visible(d.namespace)
        ]

    def _get_deployment(self, deployment_id):
        d = self.server.store.deployment_by_id(deployment_id)
        if d is None:
            matches = [
                x
                for x in self.server.store.deployments()
                if x.id.startswith(deployment_id)
            ]
            if len(matches) != 1:
                raise APIError(404, f"deployment {deployment_id} not found")
            d = matches[0]
        return d

    def handle_deployment(self, method, body, query, deployment_id):
        d = self._get_deployment(deployment_id)
        self._enforce_obj_ns(query, d.namespace, "read-job")
        return encode(d)

    def handle_deployment_promote(self, method, body, query, deployment_id):
        if method not in ("POST", "PUT"):
            raise APIError(405, "POST required")
        d = self._get_deployment(deployment_id)
        self._enforce_obj_ns(query, d.namespace, "submit-job")
        ok = self.server.deployment_watcher.promote(d.id)
        if not ok:
            raise APIError(400, "deployment is not active")
        return {"promoted": True}

    def handle_deployment_pause(self, method, body, query, deployment_id):
        """POST /v1/deployment/pause/:id {"pause": bool}
        (deployment_endpoint.go Pause)."""
        if method not in ("POST", "PUT"):
            raise APIError(405, "POST required")
        d = self._get_deployment(deployment_id)
        self._enforce_obj_ns(query, d.namespace, "submit-job")
        pause = bool((body or {}).get("pause", True))
        ok = self.server.deployment_watcher.pause(d.id, pause)
        if not ok:
            raise APIError(400, "deployment is not active")
        return {"paused": pause}

    def handle_deployment_fail(self, method, body, query, deployment_id):
        if method not in ("POST", "PUT"):
            raise APIError(405, "POST required")
        d = self._get_deployment(deployment_id)
        self._enforce_obj_ns(query, d.namespace, "submit-job")
        ok = self.server.deployment_watcher.fail(d.id)
        if not ok:
            raise APIError(400, "deployment is not active")
        return {"failed": True}

    def handle_volumes(self, method, body, query):
        """GET /v1/volumes — CSI volume stubs (csi_endpoint.go List)."""
        if method != "GET":
            raise APIError(405, "method not allowed")
        self._enforce_ns(query, "csi-list-volume")
        visible = self._ns_filter(query, "csi-list-volume")
        self._maybe_block(query)
        return [
            {
                "id": v.id,
                "namespace": v.namespace,
                "name": v.name,
                "plugin_id": v.plugin_id,
                "access_mode": v.access_mode,
                "attachment_mode": v.attachment_mode,
                "schedulable": v.schedulable,
                "claims_read": len(v.read_claims),
                "claims_write": len(v.write_claims),
                "modify_index": v.modify_index,
            }
            for v in self.server.store.csi_volumes()
            if visible(v.namespace)
        ]

    def handle_volume(self, method, body, query, volume_id):
        """GET/PUT/DELETE /v1/volume/csi/:id (csi_endpoint.go)."""
        from ..structs.volumes import CSIVolume

        if method == "GET":
            self._enforce_ns(query, "csi-read-volume")
            vol = self.server.store.csi_volume_by_id(volume_id)
            if vol is None:
                raise APIError(404, f"volume not found: {volume_id}")
            self._enforce_obj_ns(query, vol.namespace, "csi-read-volume")
            return encode(vol)
        if method == "PUT" or method == "POST":
            vol = _decode_into(CSIVolume, body or {})
            if vol.id and vol.id != volume_id:
                raise APIError(
                    400, f"volume id {vol.id!r} does not match URL {volume_id!r}"
                )
            vol.id = vol.id or volume_id
            # enforce against the volume's own namespace (cross-namespace
            # writes must not ride the query-param default)
            self._enforce_obj_ns(query, vol.namespace, "csi-write-volume")
            existing = self.server.store.csi_volume_by_id(vol.id)
            if existing is not None:
                self._enforce_obj_ns(
                    query, existing.namespace, "csi-write-volume"
                )
            try:
                self.server.register_csi_volume(vol)
            except ValueError as e:  # spec change on an in-use volume
                raise APIError(409, str(e)) from None
            return {"index": self.server.store.latest_index}
        if method == "DELETE":
            existing = self.server.store.csi_volume_by_id(volume_id)
            if existing is None:
                raise APIError(404, f"volume not found: {volume_id}")
            self._enforce_obj_ns(query, existing.namespace, "csi-write-volume")
            force = query.get("force", "") in ("true", "1")
            try:
                self.server.deregister_csi_volume(volume_id, force=force)
            except KeyError as e:
                raise APIError(404, str(e)) from None
            except ValueError as e:
                raise APIError(409, str(e)) from None
            return {"index": self.server.store.latest_index}
        raise APIError(405, "method not allowed")

    def handle_plugins(self, method, body, query):
        """GET /v1/plugins — derived CSI plugin health."""
        if method != "GET":
            raise APIError(405, "method not allowed")
        self._enforce(query, "plugin_list")
        return [
            {
                "id": p.id,
                "nodes_healthy": p.nodes_healthy,
                "controllers_healthy": p.controllers_healthy,
            }
            for p in self.server.store.csi_plugins().values()
        ]

    def handle_nodes(self, method, body, query):
        self._enforce(query, "node_read")
        self._maybe_block(query)
        return [
            {
                "id": n.id,
                "name": n.name,
                "datacenter": n.datacenter,
                "node_class": n.node_class,
                "device_class": n.device_class,
                "status": n.status,
                "scheduling_eligibility": n.scheduling_eligibility,
                "drain": n.drain is not None,
                "modify_index": n.modify_index,
            }
            for n in self.server.store.nodes()
        ]

    def _get_node(self, node_id):
        node = self.server.store.node_by_id(node_id)
        if node is None:
            # prefix match convenience (CLI-style short ids)
            matches = [
                n for n in self.server.store.nodes() if n.id.startswith(node_id)
            ]
            if len(matches) == 1:
                return matches[0]
            raise APIError(404, f"node {node_id} not found")
        return node

    def handle_node(self, method, body, query, node_id):
        self._enforce(query, "node_read")
        return encode(self._get_node(node_id))

    def handle_node_drain(self, method, body, query, node_id):
        self._enforce(query, "node_write")
        if method not in ("POST", "PUT"):
            raise APIError(405, "POST required")
        node = self._get_node(node_id)
        from ..structs import DrainStrategy

        enable = bool(body.get("drain_enabled", True)) if body else True
        drain = (
            DrainStrategy(
                deadline_s=float(body.get("deadline_s", 3600)),
                ignore_system_jobs=bool(body.get("ignore_system_jobs", False)),
            )
            if enable
            else None
        )
        evals = self.server.update_node_drain(node.id, drain)
        return {"eval_ids": [e.id for e in evals]}

    def handle_node_eligibility(self, method, body, query, node_id):
        self._enforce(query, "node_write")
        if method not in ("POST", "PUT"):
            raise APIError(405, "POST required")
        node = self._get_node(node_id)
        elig = body.get("eligibility") if body else None
        if elig not in ("eligible", "ineligible"):
            raise APIError(400, "eligibility must be eligible|ineligible")
        self.server.raft_apply(
            MsgType.NODE_ELIGIBILITY,
            {"node_id": node.id, "eligibility": elig},
        )
        return {"eligibility": elig}

    def handle_node_allocs(self, method, body, query, node_id):
        self._enforce(query, "node_read")
        node = self._get_node(node_id)
        return [encode(a) for a in self.server.store.allocs_by_node(node.id)]

    def handle_allocs(self, method, body, query):
        self._enforce_ns(query, "read-job")
        visible = self._ns_filter(query, "read-job")
        self._maybe_block(query)
        return [
            {
                "id": a.id,
                "eval_id": a.eval_id,
                "name": a.name,
                "node_id": a.node_id,
                "job_id": a.job_id,
                "task_group": a.task_group,
                "desired_status": a.desired_status,
                "client_status": a.client_status,
                "modify_index": a.modify_index,
            }
            for a in self.server.store.allocs()
            if visible(a.namespace)
        ]

    def handle_alloc(self, method, body, query, alloc_id):
        a = self.server.store.alloc_by_id(alloc_id)
        if a is None:
            matches = [
                x for x in self.server.store.allocs() if x.id.startswith(alloc_id)
            ]
            if len(matches) != 1:
                raise APIError(404, f"alloc {alloc_id} not found")
            a = matches[0]
        self._enforce_obj_ns(query, a.namespace, "read-job")
        return encode(a)

    def handle_evals(self, method, body, query):
        self._enforce_ns(query, "read-job")
        visible = self._ns_filter(query, "read-job")
        self._maybe_block(query)
        return [
            encode(e) for e in self.server.store.evals() if visible(e.namespace)
        ]

    def handle_eval(self, method, body, query, eval_id):
        e = self.server.store.eval_by_id(eval_id)
        if e is None:
            raise APIError(404, f"eval {eval_id} not found")
        self._enforce_obj_ns(query, e.namespace, "read-job")
        return encode(e)

    def handle_eval_placement(self, method, body, query, eval_id):
        """GET /v1/evaluations/:id/placement — per-task-group top-k
        score breakdowns + feasibility-rejection histograms for one
        eval (obs/explain.py). Served from the flight recorder's
        explanation ring; evals that aged out of the ring fall back to
        the structured failure metrics the eval itself carries."""
        if method != "GET":
            raise APIError(405, "method not allowed")
        e = self.server.store.eval_by_id(eval_id)
        if e is None:
            # prefix match convenience, same as handle_alloc (CLI ids)
            matches = [
                x
                for x in self.server.store.evals()
                if x.id.startswith(eval_id)
            ]
            if len(matches) != 1:
                raise APIError(404, f"eval {eval_id} not found")
            e = matches[0]
        self._enforce_obj_ns(query, e.namespace, "read-job")
        from ..obs.recorder import flight_recorder

        payload = flight_recorder.explanation(e.id)
        if payload is not None:
            return dict(payload, source="ring")
        if e.failed_tg_allocs:
            groups = {}
            for tg, m in e.failed_tg_allocs.items():
                if isinstance(m, dict):
                    rejections = dict(m.get("rejections", {}) or {})
                    metas = m.get("score_meta", []) or []
                else:
                    rejections = dict(getattr(m, "rejections", {}) or {})
                    metas = getattr(m, "score_meta", []) or []
                groups[tg] = {
                    "failed": True,
                    "rejections": rejections,
                    "top_candidates": [
                        {
                            "node_id": sm["node_id"]
                            if isinstance(sm, dict)
                            else sm.node_id,
                            "rank": i + 1,
                            "final_score": sm["norm_score"]
                            if isinstance(sm, dict)
                            else sm.norm_score,
                            "components": dict(
                                sm["scores"]
                                if isinstance(sm, dict)
                                else sm.scores
                            ),
                            "placed": 0,
                        }
                        for i, sm in enumerate(metas)
                    ],
                }
            return {
                "eval_id": e.id,
                "job_id": e.job_id,
                "namespace": e.namespace,
                "groups": groups,
                "source": "failed_tg_allocs",
            }
        raise APIError(
            404,
            f"no placement explanation for eval {e.id} "
            "(aged out of the ring, or placement_explanations disabled)",
        )

    def handle_alloc_explain(self, method, body, query, alloc_id):
        """GET /v1/allocations/:id/explain — why this alloc landed on
        its node: the alloc's own per-component score row plus (when
        the eval is still in the explanation ring) the group-level
        candidate table and rejection histogram."""
        if method != "GET":
            raise APIError(405, "method not allowed")
        a = self.server.store.alloc_by_id(alloc_id)
        if a is None:
            matches = [
                x
                for x in self.server.store.allocs()
                if x.id.startswith(alloc_id)
            ]
            if len(matches) != 1:
                raise APIError(404, f"alloc {alloc_id} not found")
            a = matches[0]
        self._enforce_obj_ns(query, a.namespace, "read-job")
        from ..obs.recorder import flight_recorder

        metrics = a.metrics
        out = {
            "alloc_id": a.id,
            "name": a.name,
            "job_id": a.job_id,
            "task_group": a.task_group,
            "node_id": a.node_id,
            "eval_id": a.eval_id,
            "scores": dict(getattr(metrics, "scores", {}) or {}),
            "score_meta": encode(getattr(metrics, "score_meta", []) or []),
        }
        payload = (
            flight_recorder.explanation(a.eval_id) if a.eval_id else None
        )
        if payload is not None:
            group = (payload.get("groups") or {}).get(a.task_group)
            if group is not None:
                out["explanation"] = group
        return out

    def handle_alloc_stop(self, method, body, query, alloc_id):
        """POST /v1/allocation/:id/stop (alloc_endpoint.go Stop): mark
        the alloc for migration and evaluate its job."""
        if method not in ("POST", "PUT"):
            raise APIError(405, "POST required")
        a = self.server.store.alloc_by_id(alloc_id)
        if a is None:
            # prefix match convenience, same as handle_alloc (CLI ids)
            matches = [
                x
                for x in self.server.store.allocs()
                if x.id.startswith(alloc_id)
            ]
            if len(matches) != 1:
                raise APIError(404, f"alloc {alloc_id} not found")
            a = matches[0]
        self._enforce_obj_ns(query, a.namespace, "submit-job")
        ev = self.server.stop_alloc(a.id)
        if ev is None:
            raise APIError(400, "alloc is already terminal")
        return {"eval_id": ev.id}

    def handle_scheduler_config(self, method, body, query):
        cfg = self.server.store.scheduler_config()
        if method == "GET":
            self._enforce(query, "operator_read")
            from ..scheduler import algorithms as sched_algorithms

            return {
                "scheduler_algorithm": cfg.scheduler_algorithm,
                "available_algorithms": sched_algorithms.available(),
                "preemption_config": {
                    "system_scheduler_enabled": cfg.preemption_system_enabled,
                    "batch_scheduler_enabled": cfg.preemption_batch_enabled,
                    "service_scheduler_enabled": cfg.preemption_service_enabled,
                },
                "memory_oversubscription_enabled": cfg.memory_oversubscription_enabled,
                "pause_eval_broker": cfg.pause_eval_broker,
                "placement_explanations": getattr(
                    cfg, "placement_explanations", True
                ),
                "throughput_source": getattr(
                    cfg, "throughput_source", "declared"
                ),
            }
        if method in ("POST", "PUT"):
            self._enforce(query, "operator_write")
            if not body:
                raise APIError(400, "missing body")
            from ..state import SchedulerConfiguration

            pc = body.get("preemption_config", {})
            new_cfg = SchedulerConfiguration(
                scheduler_algorithm=body.get(
                    "scheduler_algorithm", cfg.scheduler_algorithm
                ),
                preemption_system_enabled=pc.get(
                    "system_scheduler_enabled", cfg.preemption_system_enabled
                ),
                preemption_batch_enabled=pc.get(
                    "batch_scheduler_enabled", cfg.preemption_batch_enabled
                ),
                preemption_service_enabled=pc.get(
                    "service_scheduler_enabled", cfg.preemption_service_enabled
                ),
                placement_explanations=body.get(
                    "placement_explanations",
                    getattr(cfg, "placement_explanations", True),
                ),
                throughput_source=body.get(
                    "throughput_source",
                    getattr(cfg, "throughput_source", "declared"),
                ),
            )
            from ..scheduler import algorithms as sched_algorithms

            if not sched_algorithms.is_registered(new_cfg.scheduler_algorithm):
                raise APIError(
                    400,
                    "scheduler_algorithm must be one of: "
                    + "|".join(sched_algorithms.available()),
                )
            from ..scheduler.hetero import THROUGHPUT_SOURCES

            if new_cfg.throughput_source not in THROUGHPUT_SOURCES:
                raise APIError(
                    400,
                    "throughput_source must be one of: "
                    + "|".join(THROUGHPUT_SOURCES),
                )
            self.server.raft_apply(MsgType.SCHED_CONFIG, {"config": new_cfg})
            return {"updated": True}
        raise APIError(405, f"method {method} not allowed")

    def handle_hetero_placements(self, method, body, query):
        """GET /v1/operator/scheduler/placements — live allocation counts
        per device class, overall and per job: the observable effect of
        choosing a hetero-* algorithm (scheduler/hetero.py). Also carries
        the topology occupancy view (allocs/nodes per rack and per pod,
        from node.topology) and per-gang intactness — the observable
        effect of cp-gang and the law-15 atomic-commit seam."""
        if method != "GET":
            raise APIError(405, "method not allowed")
        self._enforce(query, "operator_read")
        store = self.server.store
        cfg = store.scheduler_config()
        per_class: dict[str, int] = {}
        per_job: dict[str, dict[str, int]] = {}
        nodes_per_class: dict[str, int] = {}
        per_rack: dict[str, dict[str, int]] = {}
        per_pod: dict[str, dict[str, int]] = {}
        for node in store.nodes():
            dc = node.device_class
            nodes_per_class[dc] = nodes_per_class.get(dc, 0) + 1
            topo = getattr(node, "topology", None) or {}
            rack = per_rack.setdefault(
                topo.get("rack", ""), {"nodes": 0, "allocs": 0}
            )
            pod = per_pod.setdefault(
                topo.get("pod", ""), {"nodes": 0, "allocs": 0}
            )
            rack["nodes"] += 1
            pod["nodes"] += 1
            for a in store.allocs_by_node(node.id):
                if a.terminal_status():
                    continue
                per_class[dc] = per_class.get(dc, 0) + 1
                rack["allocs"] += 1
                pod["allocs"] += 1
                jk = f"{a.namespace}/{a.job_id}"
                jc = per_job.setdefault(jk, {})
                jc[dc] = jc.get(dc, 0) + 1
        gangs: dict[str, dict] = {}
        for job in store.jobs():
            gang = getattr(job, "gang", None) or {}
            members = list(gang.get("groups") or ())
            if not members or job.stopped():
                continue
            desired = job.required_allocs()
            live = {m: 0 for m in members}
            for a in store.allocs_by_job(job.namespace, job.id):
                if not a.terminal_status() and a.task_group in live:
                    live[a.task_group] += 1
            gangs[f"{job.namespace}/{job.id}"] = {
                "members": dict(sorted(live.items())),
                "desired": {
                    m: desired.get(m, 0) for m in sorted(members)
                },
                "intact": all(
                    live[m] == desired.get(m, 0) for m in members
                ),
            }
        return {
            "scheduler_algorithm": cfg.scheduler_algorithm,
            "nodes_per_class": dict(sorted(nodes_per_class.items())),
            "allocs_per_class": dict(sorted(per_class.items())),
            "jobs": {
                k: dict(sorted(v.items()))
                for k, v in sorted(per_job.items())
            },
            "topology": {
                "racks": dict(sorted(per_rack.items())),
                "pods": dict(sorted(per_pod.items())),
            },
            "gangs": dict(sorted(gangs.items())),
        }

    def handle_job_versions(self, method, body, query, job_id):
        """GET /v1/job/:id/versions (job_endpoint.go GetJobVersions)."""
        ns = query.get("namespace", "default")
        self._enforce_obj_ns(query, ns, "read-job")
        versions = self.server.store.job_versions_list(ns, job_id)
        if not versions:
            cur = self.server.store.job_by_id(ns, job_id)
            if cur is None:
                raise APIError(404, f"job {job_id} not found")
            versions = [cur]
        return {
            "versions": [encode(j) for j in sorted(
                versions, key=lambda j: -j.version
            )],
        }

    def handle_job_revert(self, method, body, query, job_id):
        """POST /v1/job/:id/revert {"job_version": N} — re-registers the
        prior version (the rollback is itself a new version, like the
        reference's Job.Revert)."""
        if method not in ("POST", "PUT"):
            raise APIError(405, "POST required")
        ns = query.get("namespace", "default")
        self._enforce_obj_ns(query, ns, "submit-job")
        if not body or "job_version" not in body:
            raise APIError(400, "missing 'job_version'")
        import copy as _copy

        old = self.server.store.job_version(
            ns, job_id, int(body["job_version"])
        )
        if old is None:
            raise APIError(
                404, f"job {job_id} version {body['job_version']} not found"
            )
        ev = self.server.register_job(_copy.deepcopy(old))
        return {"eval_id": getattr(ev, "id", ""), "reverted_to": old.version}

    def handle_job_evaluate(self, method, body, query, job_id):
        """POST /v1/job/:id/evaluate — force a new evaluation
        (job_endpoint.go Evaluate)."""
        if method not in ("POST", "PUT"):
            raise APIError(405, "POST required")
        ns = query.get("namespace", "default")
        self._enforce_obj_ns(query, ns, "submit-job")
        job = self.server.store.job_by_id(ns, job_id)
        if job is None:
            raise APIError(404, f"job {job_id} not found")
        if job.is_periodic() or job.is_parameterized():
            # templates never get direct evals (job_endpoint.go Evaluate
            # rejects them; they run via periodic launch / dispatch)
            raise APIError(
                400, "can't evaluate periodic/parameterized job"
            )
        from ..structs import Evaluation
        from ..structs.evaluation import EVAL_STATUS_PENDING

        # admission gate BEFORE the eval is committed: apply_eval_create
        # is shared with internal worker followups and must stay
        # ungated, so the external trigger checks in explicitly here
        self.server.admission.check_intake(job.priority, "job-eval")
        ev = Evaluation(
            namespace=ns,
            priority=job.priority,
            type=job.type,
            triggered_by="job-eval",
            job_id=job_id,
            status=EVAL_STATUS_PENDING,
        )
        self.server.apply_eval_create([ev])
        return {"eval_id": ev.id}

    def handle_system_gc(self, method, body, query):
        """PUT /v1/system/gc — force one GC sweep
        (system_endpoint.go GarbageCollect → the _core job path)."""
        if method not in ("POST", "PUT"):
            raise APIError(405, "PUT required")
        self._enforce(query, "operator_write")
        # the manual sweep waives the age thresholds (the reference's
        # forced _core GC ignores them too)
        reaped = self.server.core_gc.gc_all(force=True)
        return {"reaped": reaped}

    def handle_raft_configuration(self, method, body, query):
        """GET /v1/operator/raft/configuration — the voting set
        (operator_endpoint.go RaftGetConfiguration)."""
        if method != "GET":
            raise APIError(405, f"method {method} not allowed")
        self._enforce(query, "operator_read")
        raft = self.server.raft
        leader = raft.leader_id()
        servers = [
            {
                "id": pid,
                "address": addr,
                "leader": pid == leader,
                "voter": True,
            }
            for pid, addr in sorted(raft.peers().items())
        ]
        return {"servers": servers, "index": self.server.store.latest_index}

    def handle_raft_peer(self, method, body, query):
        """DELETE /v1/operator/raft/peer?id=<node_id> — remove a peer from
        the voting set (operator_endpoint.go RaftRemovePeerByID)."""
        if method != "DELETE":
            raise APIError(405, f"method {method} not allowed")
        self._enforce(query, "operator_write")
        # the query's values are strings (one per key): the JAX
        # package indexes this one, and so reads its first character
        # (ROADMAP C-R10)
        pid = query.get("id") or ""
        if not pid:
            raise APIError(400, "missing ?id=<node_id>")
        from ..raft import NotLeaderError

        try:
            self.server.raft.remove_peer(pid)
        except ValueError as e:
            raise APIError(400, str(e))
        except NotLeaderError as e:
            # membership changes commit on the leader; tell the operator
            # where to retry instead of a bare 500 (the CLI surfaces it)
            raise APIError(
                421,
                f"not the leader — retry against "
                f"{e.leader_addr or e.leader_id or 'the leader'}",
            )
        return {"removed": pid}

    def handle_operator_defrag(self, method, body, query):
        """/v1/operator/defrag — the live-migration control plane.

        GET returns the controller's status block (enabled/paused,
        interval, budget, packing-efficiency gauge, move counters).
        POST triggers an immediate defrag cycle regardless of the
        periodic interval; ``{"paused": true|false}`` in the body flips
        the pause latch instead (a paused controller plans nothing but
        keeps serving recovery via trigger)."""
        defrag = self.server.defrag
        if method == "GET":
            self._enforce(query, "operator_read")
            return defrag.status()
        if method not in ("POST", "PUT"):
            raise APIError(405, f"method {method} not allowed")
        self._enforce(query, "operator_write")
        if isinstance(body, dict) and "paused" in body:
            defrag.paused = bool(body["paused"])
            return defrag.status()
        defrag.trigger()
        out = defrag.status()
        out["triggered"] = True
        return out

    def handle_job_dispatch(self, method, body, query, job_id):
        if method not in ("POST", "PUT"):
            raise APIError(405, "POST required")
        self._enforce_ns(query, "dispatch-job")
        body = body or {}
        ns = query.get("namespace", "default")
        import base64

        payload = base64.b64decode(body.get("payload", "") or "")
        try:
            child, ev = self.server.dispatch_job(
                ns, job_id, payload=payload, meta=body.get("meta") or {}
            )
        except ValueError as e:
            raise APIError(400, str(e)) from None
        return {"dispatched_job_id": child.id, "eval_id": ev.id}

    def handle_periodic_force(self, method, body, query, job_id):
        if method not in ("POST", "PUT"):
            raise APIError(405, "POST required")
        self._enforce_ns(query, "submit-job")
        job = self._get_job(job_id, query)
        if not job.is_periodic():
            raise APIError(400, f"job {job_id} is not periodic")
        child = self.server.periodic.force_launch(job)
        if child is None:
            raise APIError(400, "launch skipped (prohibit_overlap)")
        return {"launched_job_id": child.id}

    # -- namespaces (namespace_endpoint.go) --------------------------------
    def handle_namespaces(self, method, body, query):
        if method != "GET":
            raise APIError(405, "method not allowed")
        acl = self._acl(query)
        out = [
            {
                "name": n.name, "description": n.description,
                "create_index": n.create_index,
                "modify_index": n.modify_index,
            }
            for n in self.server.store.namespaces()
        ]
        # the default namespace always exists implicitly
        if not any(n["name"] == "default" for n in out):
            out.insert(0, {"name": "default",
                           "description": "Default shared namespace",
                           "create_index": 1, "modify_index": 1})
        if acl is not None:  # List filters to visible namespaces
            out = [n for n in out if acl.allow_namespace(n["name"])]
        return sorted(out, key=lambda n: n["name"])

    def handle_namespace(self, method, body, query, name):
        from ..structs.job import Namespace

        if method == "GET":
            acl = self._acl(query)
            if acl is not None and not acl.allow_namespace(name):
                raise APIError(403, "Permission denied")
            if name == "default":
                return {"name": "default",
                        "description": "Default shared namespace"}
            ns = self.server.store.namespace_by_name(name)
            if ns is None:
                raise APIError(404, f"namespace not found: {name}")
            return encode(ns)
        if method in ("PUT", "POST"):
            self._enforce_management(query)
            ns = Namespace(
                name=name,
                description=(body or {}).get("description", ""),
            )
            try:
                self.server.upsert_namespace(ns)
            except ValueError as e:
                raise APIError(400, str(e)) from None
            return {"index": self.server.store.latest_index}
        if method == "DELETE":
            self._enforce_management(query)
            try:
                self.server.delete_namespace(name)
            except KeyError as e:
                raise APIError(404, str(e)) from None
            except ValueError as e:
                raise APIError(409, str(e)) from None
            return {"index": self.server.store.latest_index}
        raise APIError(405, "method not allowed")

    def handle_namespace_create(self, method, body, query):
        if method not in ("PUT", "POST"):
            raise APIError(405, "PUT required")
        name = (body or {}).get("name", "")
        return self.handle_namespace("PUT", body, query, name)

    # -- scaling (job_endpoint Scale + scaling_endpoint.go) -----------------
    def handle_job_scale(self, method, body, query, job_id):
        ns = query.get("namespace", "default")
        if method == "GET":
            self._enforce_ns(query, "read-job-scaling")
            job = self.server.store.job_by_id(ns, job_id)
            if job is None:
                raise APIError(404, f"job not found: {job_id}")
            return {
                "job_id": job.id,
                "namespace": job.namespace,
                "job_stopped": job.stopped(),
                "task_groups": {
                    tg.name: {
                        "desired": tg.count,
                        "running": sum(
                            1
                            for a in self.server.store.allocs_by_job(ns, job.id)
                            if a.task_group == tg.name
                            and a.client_status == "running"
                        ),
                        "events": self.server.store.scaling_events(ns, job.id),
                    }
                    for tg in job.task_groups
                },
            }
        if method in ("POST", "PUT"):
            self._enforce_ns(query, "scale-job")
            body = body or {}
            target = body.get("target", {})
            group = target.get("group") or target.get("Group")
            count = body.get("count")
            if not group or count is None:
                raise APIError(400, "target.group and count required")
            try:
                ev = self.server.scale_job(
                    ns, job_id, group, int(count),
                    message=body.get("message", ""),
                    error=bool(body.get("error", False)),
                )
            except KeyError as e:
                raise APIError(404, str(e)) from None
            except ValueError as e:
                raise APIError(400, str(e)) from None
            return {"eval_id": ev.id, "index": self.server.store.latest_index}
        raise APIError(405, "method not allowed")

    def handle_scaling_policies(self, method, body, query):
        if method != "GET":
            raise APIError(405, "method not allowed")
        self._enforce_ns(query, "list-scaling-policies")
        visible = self._ns_filter(query, "list-scaling-policies")
        out = []
        for job in self.server.store.jobs():
            if not visible(job.namespace):
                continue
            for tg in job.task_groups:
                if tg.scaling is not None:
                    out.append(
                        {
                            "id": f"{job.namespace}/{job.id}/{tg.name}",
                            "namespace": job.namespace,
                            "job_id": job.id,
                            "group": tg.name,
                            "min": tg.scaling.min,
                            "max": tg.scaling.max,
                            "enabled": tg.scaling.enabled,
                            "policy": tg.scaling.policy,
                        }
                    )
        return out

    # -- search (nomad/search_endpoint.go) ----------------------------------
    SEARCH_CONTEXTS = ("jobs", "nodes", "allocs", "evals", "deployments",
                       "volumes", "namespaces")
    SEARCH_TRUNCATE = 20  # search_endpoint.go truncateLimit

    def handle_search(self, method, body, query):
        if method not in ("POST", "PUT"):
            raise APIError(405, "POST required")
        body = body or {}
        prefix = body.get("prefix", "")
        context = body.get("context", "all") or "all"
        contexts = (
            self.SEARCH_CONTEXTS if context == "all" else (context,)
        )
        ns = query.get("namespace", "default")
        store = self.server.store
        matches, truncations = {}, {}

        def collect(name, ids):
            hits = sorted(i for i in ids if i.startswith(prefix))
            truncations[name] = len(hits) > self.SEARCH_TRUNCATE
            matches[name] = hits[: self.SEARCH_TRUNCATE]

        for ctx in contexts:
            if ctx == "jobs":
                self._enforce_ns(query, "read-job")
                collect("jobs", [
                    j.id for j in store.jobs() if j.namespace == ns
                ])
            elif ctx == "nodes":
                collect("nodes", [n.id for n in store.nodes()])
            elif ctx == "allocs":
                collect("allocs", [
                    a.id for a in store.allocs() if a.namespace == ns
                ])
            elif ctx == "evals":
                collect("evals", [
                    e.id for e in store.evals() if e.namespace == ns
                ])
            elif ctx == "deployments":
                collect("deployments", [
                    d.id for d in store.deployments() if d.namespace == ns
                ])
            elif ctx == "volumes":
                collect("volumes", [v.id for v in store.csi_volumes()])
            elif ctx == "namespaces":
                names = [n.name for n in store.namespaces()] + ["default"]
                collect("namespaces", names)
            else:
                raise APIError(400, f"invalid context {ctx!r}")
        return {"matches": matches, "truncations": truncations}

    # -- client fs/logs proxy (command/agent/fs_endpoint.go) ---------------
    def _client_rpc_for_alloc(self, alloc_id, query):
        """Resolve alloc → node → the client's advertised RPC address
        (client/fs_endpoint.go reachability via node attribute)."""
        from ..client.endpoints import ATTR_RPC_ADDR
        from ..rpc import RPCClient

        alloc = self.server.store.alloc_by_id(alloc_id)
        if alloc is None:
            matches = [
                x for x in self.server.store.allocs()
                if x.id.startswith(alloc_id)
            ]
            if len(matches) != 1:
                raise APIError(404, f"alloc not found: {alloc_id}")
            alloc = matches[0]
        self._enforce_obj_ns(query, alloc.namespace, "read-fs")
        node = self.server.store.node_by_id(alloc.node_id)
        addr = (node.attributes or {}).get(ATTR_RPC_ADDR) if node else None
        if not addr:
            raise APIError(
                404, f"node for alloc {alloc.id[:8]} has no client RPC"
            )
        return RPCClient(addr), alloc

    def handle_fs_ls(self, method, body, query, alloc_id):
        if method != "GET":
            raise APIError(405, "method not allowed")
        c, alloc = self._client_rpc_for_alloc(alloc_id, query)
        try:
            return c.call(
                "FS.list",
                {"alloc_id": alloc.id, "path": query.get("path", "/")},
            )
        finally:
            c.close()

    def handle_fs_cat(self, method, body, query, alloc_id):
        if method != "GET":
            raise APIError(405, "method not allowed")
        c, alloc = self._client_rpc_for_alloc(alloc_id, query)
        try:
            data = c.call(
                "FS.read",
                {
                    "alloc_id": alloc.id,
                    "path": query.get("path", "/"),
                    "offset": int(query.get("offset", 0)),
                    "limit": int(query.get("limit", 1 << 20)),
                },
            )
            return {"data": data.decode("utf-8", "replace")}
        finally:
            c.close()

    def handle_fs_logs(self, method, body, query, alloc_id):
        if method != "GET":
            raise APIError(405, "method not allowed")
        task = query.get("task")
        if not task:
            raise APIError(400, "task parameter required")
        c, alloc = self._client_rpc_for_alloc(alloc_id, query)
        follow = query.get("follow", "") in ("true", "1")

        def gen():
            try:
                for chunk in c.stream(
                    "FS.logs",
                    {
                        "alloc_id": alloc.id,
                        "task": task,
                        "type": query.get("type", "stdout"),
                        "follow": follow,
                        "offset": int(query.get("offset", 0)),
                    },
                    timeout=3600 if follow else 30,
                ):
                    yield json.dumps(chunk)  # NDJSON frames
            finally:
                c.close()

        return StreamingResponse(gen())

    def handle_event_stream(self, method, body, query):
        """NDJSON event stream (http.go:359 /v1/event/stream). Events are
        ACL-filtered per topic: Node events need node:read, namespaced
        topics need read-job on the event's namespace (the reference's
        aclFilter in nomad/stream/event_broker.go). The token is
        re-resolved on every poll so revocation/downgrade takes effect on
        long-lived streams (event_broker.go checkSubscriptionACLs)."""
        self._acl(query)  # reject bad tokens before subscribing
        secret = query.get("_secret", "")

        def current_acl():
            from ..server.acl import TokenError

            try:
                return self.server.acl.resolve_token(secret)
            except TokenError:
                return False  # token revoked mid-stream: terminate

        def event_visible(ev, acl) -> bool:
            if acl is None or acl.is_management():
                return True
            if ev.topic == "Node":
                return acl.allow_node_read()
            return acl.allow_namespace_operation(
                ev.namespace or "default", "read-job"
            )

        from_index = int(query.get("index", 0) or 0)
        topics = None
        if "topic" in query:
            # topic=Job:* or topic=Node:node-id
            topics = {}
            for spec in query["topic"].split(","):
                topic, _, key = spec.partition(":")
                topics.setdefault(topic, []).append(key or "*")
        limit = int(query.get("limit", 0) or 0)  # test hook: stop after N
        sub = self.server.events.subscribe(topics, from_index)

        def gen():
            n = 0
            deadline = None
            wait = float(query.get("wait", 30.0) or 30.0)
            import time as _t

            deadline = _t.time() + wait
            while _t.time() < deadline:
                acl = current_acl()
                if acl is False:
                    return  # token revoked: close the stream
                for ev in sub.next_events(timeout=0.5):
                    if not event_visible(ev, acl):
                        continue
                    yield ev.to_json()
                    n += 1
                    if limit and n >= limit:
                        return

        return StreamingResponse(gen())

    def handle_snapshot_save(self, method, body, query):
        if method not in ("POST", "PUT"):
            raise APIError(405, "POST required")
        self._enforce(query, "operator_write")
        path = (body or {}).get("path")
        if not path:
            raise APIError(400, "missing 'path'")
        from ..state.snapshot import save_snapshot

        index = save_snapshot(self.server.store, path)
        return {"index": index, "path": path}

    def handle_agent_self(self, method, body, query):
        self._enforce(query, "agent_read")
        out = {
            "member": {"name": "server-1", "status": "alive"},
            "stats": {
                "worker_count": len(self.server.workers),
                "plan_queue_depth": self.server.plan_queue.depth(),
                "blocked_evals": self.server.blocked_evals.blocked_count(),
            },
            "version": __import__("nomad_tpu_torch").__version__,
        }
        if self.client is not None:
            out["client"] = {
                "node_id": self.client.node.id,
                "allocs_running": self.client.num_allocs(),
            }
        return out

    def handle_leader(self, method, body, query):
        return f"{self.host}:{self.port}"

    def handle_metrics(self, method, body, query):
        self._enforce(query, "agent_read")
        from ..utils.metrics import global_metrics

        return global_metrics.snapshot()

    def handle_pprof(self, method, body, query, kind):
        """/v1/agent/pprof/{goroutine,profile,heap} — thread dump,
        sampling CPU profile, heap stats (utils/profile.py; reference
        command/agent/http.go:331 gates these behind agent:read too)."""
        self._enforce(query, "agent_read")
        from ..utils import profile as prof

        if kind == "goroutine":
            return prof.thread_dump()
        if kind == "profile":
            seconds = min(float(query.get("seconds", 1.0)), 30.0)
            return prof.sample_profile(seconds)
        if kind == "heap":
            return prof.heap_profile()
        raise APIError(404, f"unknown pprof kind {kind!r}")

    def handle_operator_debug(self, method, body, query):
        self._enforce(query, "agent_read")
        from ..utils.profile import debug_bundle

        return debug_bundle(self.server)

    def handle_agent_trace(self, method, body, query, eval_id=None):
        """/v1/agent/trace[/{eval_id}] — flight-recorder dump: recent
        completed eval traces (summaries), last-N error events, and the
        per-kernel profile; with an eval id, the full span tree."""
        self._enforce(query, "agent_read")
        from ..obs.recorder import flight_recorder

        if eval_id:
            trace = flight_recorder.get(eval_id)
            if trace is None:
                raise APIError(404, f"no trace for eval {eval_id!r}")
            return trace
        from ..backend import kernel_profile

        return {
            "traces": flight_recorder.list(int(query.get("n", 50))),
            "errors": flight_recorder.errors(),
            # the kernel guard's per-kernel table (backend.guarded_call),
            # keyed by the JAX package's kernel names
            "kernels": kernel_profile(),
            # the JAX package's jaxpr fingerprints; the port's kernels
            # have no jaxpr and their lint is not ported yet (ROADMAP
            # A17). {} is the JAX package's own answer when its table
            # cannot be built.
            "kernel_fingerprints": {},
            # incremental-rescoring accounting (device/cache.py):
            # rows patched vs served resident, generation swaps, and
            # the pipeline-overlap wall time the commit thread hid
            "device_cache": self.server.device_cache.device_counters(),
            # gang scheduling ledger: kernel-level commits/releases
            # (scheduler/cp.py nomad.cp.gang_*) plus the law-15 atomic
            # release seam (scheduler/generic.py nomad.gang.*)
            "gang": self._gang_counters(),
            # migration-plane ledger (server/defrag.py, law 16): the
            # two-phase move counters plus the drainer's graceful-vs-
            # forced exit split
            "migrate": self._migrate_counters(),
        }

    @staticmethod
    def _gang_counters() -> dict:
        from ..utils.metrics import global_metrics

        counters = global_metrics.snapshot()["counters"]
        return {
            k: v
            for k, v in sorted(counters.items())
            if k.startswith(("nomad.gang.", "nomad.cp.gang_"))
        }

    @staticmethod
    def _migrate_counters() -> dict:
        from ..utils.metrics import global_metrics

        snap = global_metrics.snapshot()
        out = {
            k: v
            for k, v in sorted(snap["counters"].items())
            if k.startswith(("nomad.migrate.", "nomad.drain."))
        }
        gauge = snap["gauges"].get("nomad.migrate.packing_efficiency")
        if gauge is not None:
            out["nomad.migrate.packing_efficiency"] = round(gauge, 6)
        return out

    def handle_agent_resilience(self, method, body, query):
        """/v1/agent/resilience — per-kernel circuit-breaker snapshots,
        the forced-open override, recent trip events from the flight
        recorder, and the resilience counter slice of the metrics
        registry (``nomad-tpu resilience status`` reads this)."""
        self._enforce(query, "agent_read")
        from ..obs.recorder import flight_recorder
        from ..resilience.breaker import forced_open, snapshot_all
        from ..utils.metrics import global_metrics

        counters = global_metrics.snapshot()["counters"]
        srv = self.server
        return {
            "breakers": snapshot_all(),
            "forced_open": forced_open(),
            "recent_trips": [
                e
                for e in flight_recorder.errors()
                if e.get("component") == "resilience"
            ],
            "lanes": {
                "lane_mode": srv.lane_mode,
                "num_lanes": srv.lanes.num_lanes,
                "num_batch_workers": srv.lanes.num_batch_workers,
                "assignments": {
                    str(w): list(ls)
                    for w, ls in srv.lanes.assignments().items()
                },
                "claims": srv.lane_claims.snapshot(),
            },
            "admission": (
                srv.admission.snapshot()
                if getattr(srv, "admission", None) is not None
                else None
            ),
            "counters": {
                k: v
                for k, v in counters.items()
                if k.startswith("nomad.resilience.")
                or k.startswith("nomad.plan.lane_")
                or k.startswith("nomad.worker.lane_")
                or k.startswith("nomad.admission.")
                or k == "nomad.plan.cross_lane_handoffs"
                or k == "nomad.broker.nack_redelivery_delayed"
            },
        }

    def handle_agent_calibration(self, method, body, query):
        """/v1/agent/calibration — the calibration plane: every
        operational constant with its provenance (default/probe/
        learned), the loaded probe artifact if any, the throughput
        estimator's learned cells, and the active throughput source
        (``nomad-tpu calibrate status|report`` reads this)."""
        self._enforce(query, "agent_read")
        srv = self.server
        cfg = srv.store.scheduler_config()
        table = getattr(srv, "calibration", None)
        est = getattr(srv, "throughput_estimator", None)
        if table is None:
            from ..obs.calibrate import global_table as table
        if est is None:
            from ..obs.calibrate import global_estimator as est
        return {
            "table": table.snapshot(),
            "estimator": est.snapshot(),
            "throughput_source": getattr(
                cfg, "throughput_source", "declared"
            ),
        }

    def handle_agent_slo(self, method, body, query):
        """/v1/agent/slo — the live SLO report: eval/placement latency
        percentiles from the always-on ``nomad.slo.*`` series the
        flight recorder feeds, current queue depth, resilience/lane
        counters, flight-recorder ring coverage, and the verdict
        against targets (defaults; override any ``SloTargets`` field
        via a query parameter, e.g. ``?eval_p99_ms=100``)."""
        self._enforce(query, "agent_read")
        from ..obs.slo import SloTargets, live_report

        targets = SloTargets()
        for f in SloTargets.FIELDS:
            if f in query:
                raw = query[f]
                setattr(
                    targets, f,
                    None if raw in ("", "none", "null") else float(raw),
                )
        return live_report(self.server, targets)

    # -- ACL endpoints (nomad/acl_endpoint.go) -----------------------------
    def handle_acl_bootstrap(self, method, body, query):
        if method not in ("POST", "PUT"):
            raise APIError(405, "POST required")
        try:
            token = self.server.acl.bootstrap()
        except PermissionError as e:
            raise APIError(400, str(e)) from None
        return token.to_api()

    def handle_acl_policies(self, method, body, query):
        self._enforce_management(query)
        self._maybe_block(query)
        return [
            {
                "Name": p.name,
                "Description": p.description,
                "CreateIndex": p.create_index,
                "ModifyIndex": p.modify_index,
            }
            for p in self.server.store.acl_policies()
        ]

    def handle_acl_policy(self, method, body, query, name):
        from ..acl import ACLPolicyRecord, AclPolicyError

        if method == "GET":
            # a token may read the policies attached to itself
            acl = self._acl(query)
            if acl is not None and not acl.is_management():
                token = self.server.store.acl_token_by_secret(
                    query.get("_secret", "")
                )
                if token is None or name not in token.policies:
                    raise APIError(403, "Permission denied")
            p = self.server.store.acl_policy_by_name(name)
            if p is None:
                raise APIError(404, f"policy {name} not found")
            return p.to_api()
        if method in ("POST", "PUT"):
            self._enforce_management(query)
            body = body or {}
            rec = ACLPolicyRecord(
                name=name,
                description=body.get("Description", body.get("description", "")),
                rules=body.get("Rules", body.get("rules", "")),
            )
            try:
                self.server.acl.upsert_policies([rec])
            except (AclPolicyError, ValueError) as e:
                raise APIError(400, str(e)) from None
            return {"updated": True}
        if method == "DELETE":
            self._enforce_management(query)
            self.server.acl.delete_policies([name])
            return {"deleted": True}
        raise APIError(405, f"method {method} not allowed")

    def handle_acl_tokens(self, method, body, query):
        self._enforce_management(query)
        self._maybe_block(query)
        return [t.to_api(redact_secret=True) for t in self.server.store.acl_tokens()]

    def handle_acl_token_create(self, method, body, query):
        if method not in ("POST", "PUT"):
            raise APIError(405, "POST required")
        self._enforce_management(query)
        from ..acl import ACLToken

        body = body or {}
        token = ACLToken(
            name=body.get("Name", body.get("name", "")),
            type=body.get("Type", body.get("type", "client")),
            policies=body.get("Policies", body.get("policies", [])) or [],
            global_=body.get("Global", body.get("global", False)),
        )
        try:
            self.server.acl.upsert_tokens([token])
        except ValueError as e:
            raise APIError(400, str(e)) from None
        return token.to_api()

    def handle_acl_token_self(self, method, body, query):
        if method != "GET":
            raise APIError(405, "GET required")
        secret = query.get("_secret", "")
        token = self.server.store.acl_token_by_secret(secret)
        if token is None:
            raise APIError(403, "ACL token not found")
        return token.to_api()

    def handle_acl_token(self, method, body, query, accessor):
        if method == "GET":
            self._enforce_management(query)
            t = self.server.store.acl_token_by_accessor(accessor)
            if t is None:
                raise APIError(404, f"token {accessor} not found")
            return t.to_api()
        if method == "DELETE":
            self._enforce_management(query)
            self.server.acl.delete_tokens([accessor])
            return {"deleted": True}
        raise APIError(405, f"method {method} not allowed")
