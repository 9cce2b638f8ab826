"""Python SDK — the api/ package analog.

Reference: api/ (19.5k LoC standalone Go module mirroring every HTTP
endpoint: api.go, jobs.go, nodes.go, allocations.go, evaluations.go,
operator.go). Stdlib urllib transport; one class per noun, hung off
``NomadClient`` exactly like api.Client's accessors."""

from __future__ import annotations

import json
import os
import urllib.error
import urllib.request
from typing import Any, Optional


class APIException(Exception):
    def __init__(self, status: int, message: str):
        super().__init__(f"HTTP {status}: {message}")
        self.status = status


class NomadClient:
    def __init__(
        self,
        address: str = "http://127.0.0.1:4646",
        timeout: float = 10.0,
        token: str = "",
    ):
        self.address = address.rstrip("/")
        self.timeout = timeout
        # ACL secret (api/api.go SetSecretID; header X-Nomad-Token)
        self.token = token or os.environ.get("NOMAD_TOKEN", "")

    # -- transport ---------------------------------------------------------
    def _request(
        self,
        method: str,
        path: str,
        body: Any = None,
        params: Optional[dict] = None,
    ):
        url = self.address + path
        if params:
            from urllib.parse import urlencode

            url += "?" + urlencode(params)
        data = json.dumps(body).encode() if body is not None else None
        headers = {"Content-Type": "application/json"}
        if self.token:
            headers["X-Nomad-Token"] = self.token
        req = urllib.request.Request(
            url, data=data, method=method, headers=headers
        )
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as resp:
                return json.loads(resp.read() or b"null")
        except urllib.error.HTTPError as e:
            try:
                msg = json.loads(e.read()).get("error", str(e))
            except Exception:  # noqa: BLE001
                msg = str(e)
            raise APIException(e.code, msg) from None

    def get(self, url_path, **params):
        return self._request("GET", url_path, params=params or None)

    def post(self, url_path, body=None, **params):
        return self._request(
            "POST", url_path, body=body, params=params or None
        )

    def delete(self, url_path, **params):
        return self._request("DELETE", url_path, params=params or None)

    # -- nouns -------------------------------------------------------------
    @property
    def jobs(self) -> "Jobs":
        return Jobs(self)

    @property
    def nodes(self) -> "Nodes":
        return Nodes(self)

    @property
    def allocations(self) -> "Allocations":
        return Allocations(self)

    @property
    def evaluations(self) -> "Evaluations":
        return Evaluations(self)

    @property
    def deployments(self) -> "Deployments":
        return Deployments(self)

    @property
    def operator(self) -> "Operator":
        return Operator(self)

    @property
    def agent(self) -> "Agent":
        return Agent(self)

    @property
    def namespaces(self) -> "Namespaces":
        return Namespaces(self)

    @property
    def scaling(self) -> "Scaling":
        return Scaling(self)

    def search(self, prefix: str, context: str = "all",
               namespace: str = "default"):
        return self.post(
            "/v1/search", {"prefix": prefix, "context": context},
            namespace=namespace,
        )

    @property
    def volumes(self) -> "Volumes":
        return Volumes(self)


class Jobs:
    def __init__(self, c: NomadClient):
        self.c = c

    def list(self):
        return self.c.get("/v1/jobs")

    def register(self, job_dict: dict):
        return self.c.post("/v1/jobs", {"job": job_dict})

    def plan(self, job_dict: dict):
        return self.c.post(f"/v1/job/{job_dict['id']}/plan", {"job": job_dict})

    def info(self, job_id: str, namespace: str = "default"):
        return self.c.get(f"/v1/job/{job_id}", namespace=namespace)

    def deregister(self, job_id: str, namespace: str = "default"):
        return self.c.delete(f"/v1/job/{job_id}", namespace=namespace)

    def allocations(self, job_id: str, namespace: str = "default"):
        return self.c.get(f"/v1/job/{job_id}/allocations", namespace=namespace)

    def evaluations(self, job_id: str, namespace: str = "default"):
        return self.c.get(f"/v1/job/{job_id}/evaluations", namespace=namespace)

    def summary(self, job_id: str, namespace: str = "default"):
        return self.c.get(f"/v1/job/{job_id}/summary", namespace=namespace)

    def dispatch(
        self, job_id: str, payload: bytes = b"", meta=None, namespace: str = "default"
    ):
        import base64

        return self.c.post(
            f"/v1/job/{job_id}/dispatch",
            {
                "payload": base64.b64encode(payload).decode(),
                "meta": meta or {},
            },
            namespace=namespace,
        )

    def scale(self, job_id: str, group: str, count: int,
              message: str = "", namespace: str = "default"):
        return self.c.post(
            f"/v1/job/{job_id}/scale",
            {"target": {"group": group}, "count": count, "message": message},
            namespace=namespace,
        )

    def scale_status(self, job_id: str, namespace: str = "default"):
        return self.c.get(f"/v1/job/{job_id}/scale", namespace=namespace)

    def periodic_force(self, job_id: str, namespace: str = "default"):
        return self.c.post(
            f"/v1/job/{job_id}/periodic/force", namespace=namespace
        )


class Nodes:
    def __init__(self, c: NomadClient):
        self.c = c

    def list(self):
        return self.c.get("/v1/nodes")

    def info(self, node_id: str):
        return self.c.get(f"/v1/node/{node_id}")

    def drain(self, node_id: str, enabled: bool = True, deadline_s: float = 3600):
        return self.c.post(
            f"/v1/node/{node_id}/drain",
            {"drain_enabled": enabled, "deadline_s": deadline_s},
        )

    def eligibility(self, node_id: str, eligible: bool):
        return self.c.post(
            f"/v1/node/{node_id}/eligibility",
            {"eligibility": "eligible" if eligible else "ineligible"},
        )

    def allocations(self, node_id: str):
        return self.c.get(f"/v1/node/{node_id}/allocations")


class Allocations:
    def __init__(self, c: NomadClient):
        self.c = c

    def list(self):
        return self.c.get("/v1/allocations")

    def info(self, alloc_id: str):
        return self.c.get(f"/v1/allocation/{alloc_id}")

    def explain(self, alloc_id: str):
        """Score provenance: why this alloc landed on its node
        (`nomad-tpu alloc why`)."""
        return self.c.get(f"/v1/allocations/{alloc_id}/explain")

    def fs_ls(self, alloc_id: str, fs_path: str = "/"):
        return self.c.get(
            f"/v1/client/fs/ls/{alloc_id}", **{"path": fs_path}
        )

    def fs_cat(self, alloc_id: str, fs_path: str, offset: int = 0,
               limit: int = 1 << 20):
        return self.c.get(
            f"/v1/client/fs/cat/{alloc_id}",
            **{"path": fs_path, "offset": offset, "limit": limit},
        )["data"]

    def logs(self, alloc_id: str, task: str, type: str = "stdout",
             follow: bool = False, offset: int = 0):
        """Iterate log frames ({'offset': n, 'data': str}); with
        ``follow`` streams until the connection closes (api/fs.go Logs)."""
        import urllib.error
        import urllib.request
        from urllib.parse import urlencode

        params = urlencode({
            "task": task, "type": type,
            "follow": "true" if follow else "false", "offset": offset,
        })
        url = (
            f"{self.c.address}/v1/client/fs/logs/{alloc_id}?{params}"
        )
        req = urllib.request.Request(url)
        try:
            resp = urllib.request.urlopen(
                req, timeout=None if follow else self.c.timeout
            )
        except urllib.error.HTTPError as e:
            try:
                msg = json.loads(e.read()).get("error", str(e))
            except Exception:  # noqa: BLE001
                msg = str(e)
            raise APIException(e.code, msg) from None

        def gen():
            import json as _json

            with resp:
                for line in resp:
                    line = line.strip()
                    if line:
                        yield _json.loads(line)

        return gen()


class Evaluations:
    def __init__(self, c: NomadClient):
        self.c = c

    def list(self):
        return self.c.get("/v1/evaluations")

    def info(self, eval_id: str):
        return self.c.get(f"/v1/evaluation/{eval_id}")

    def placement(self, eval_id: str):
        """Per-task-group placement explanation (candidate table +
        rejection histogram) for one eval."""
        return self.c.get(f"/v1/evaluations/{eval_id}/placement")


class Deployments:
    def __init__(self, c: NomadClient):
        self.c = c

    def list(self):
        return self.c.get("/v1/deployments")

    def info(self, deployment_id: str):
        return self.c.get(f"/v1/deployment/{deployment_id}")

    def for_job(self, job_id: str, namespace: str = "default"):
        return self.c.get(f"/v1/job/{job_id}/deployments", namespace=namespace)

    def promote(self, deployment_id: str):
        return self.c.post(f"/v1/deployment/promote/{deployment_id}")

    def pause(self, deployment_id: str, pause: bool = True):
        return self.c.post(
            f"/v1/deployment/pause/{deployment_id}", {"pause": pause}
        )

    def fail(self, deployment_id: str):
        return self.c.post(f"/v1/deployment/fail/{deployment_id}")


class Operator:
    def __init__(self, c: NomadClient):
        self.c = c

    def scheduler_config(self):
        return self.c.get("/v1/operator/scheduler/configuration")

    def snapshot_save(self, path: str):
        return self.c.post("/v1/operator/snapshot/save", {"path": path})

    def set_scheduler_config(self, **kwargs):
        return self.c.post("/v1/operator/scheduler/configuration", kwargs)


class Volumes:
    """CSI volumes (api/csi.go analog)."""

    def __init__(self, c: NomadClient):
        self.c = c

    def list(self):
        return self.c.get("/v1/volumes")

    def info(self, volume_id: str):
        return self.c.get(f"/v1/volume/csi/{volume_id}")

    def register(self, volume_dict: dict):
        return self.c.post(
            f"/v1/volume/csi/{volume_dict['id']}", volume_dict
        )

    def deregister(self, volume_id: str, force: bool = False):
        params = {"force": "true"} if force else {}
        return self.c.delete(f"/v1/volume/csi/{volume_id}", **params)

    def plugins(self):
        return self.c.get("/v1/plugins")


class Agent:
    def __init__(self, c: NomadClient):
        self.c = c

    def self(self):
        return self.c.get("/v1/agent/self")

    def metrics(self):
        return self.c.get("/v1/metrics")


class Namespaces:
    def __init__(self, c: NomadClient):
        self.c = c

    def list(self):
        return self.c.get("/v1/namespaces")

    def info(self, name: str):
        return self.c.get(f"/v1/namespace/{name}")

    def apply(self, name: str, description: str = ""):
        return self.c.post(
            f"/v1/namespace/{name}", {"description": description}
        )

    def delete(self, name: str):
        return self.c.delete(f"/v1/namespace/{name}")


class Scaling:
    def __init__(self, c: NomadClient):
        self.c = c

    def policies(self, namespace: str = "default"):
        return self.c.get("/v1/scaling/policies", namespace=namespace)
