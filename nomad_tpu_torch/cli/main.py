"""CLI — ``python -m nomad_tpu_torch.cli``.

Reference: command/ (~120 subcommands via mitchellh/cli). The operational
core subset: agent -dev, job run/plan/status/stop, node status/drain/
eligibility, alloc status, eval status, operator scheduler-config,
server members. Talks to the HTTP API via the SDK (never in-process),
matching the reference CLI's strict HTTP boundary.

The JAX package's ``cli/main.py`` on the port: ``agent -dev``, ``chaos
run`` and ``analyze kernels`` (the kernel lint, ``analysis/kernellint``)
take ``--device`` (default ``cuda``; ``cpu`` to ask for the CPU), and
``version`` reads this package. A command that only speaks HTTP
imports neither the server nor PyTorch (the scheduler algorithms behind
``operator scheduler --algorithm`` load when that flag is given).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

from ..api.client import APIException, NomadClient

DEFAULT_ADDR = os.environ.get("NOMAD_TPU_ADDR", "http://127.0.0.1:4646")


def _client(args) -> NomadClient:
    return NomadClient(args.address, token=getattr(args, "token", ""))


def _fail(msg: str) -> int:
    print(f"error: {msg}", file=sys.stderr)
    return 1


def _load_jobfile(path: str, variables: dict | None = None) -> dict:
    """Read a job file: HCL (.hcl/.nomad, the canonical format) or JSON.
    Mirrors command/job_run.go, which feeds files through jobspec2."""
    try:
        with open(path) as f:
            src = f.read()
    except OSError as e:
        raise SystemExit(f"error: cannot read job file: {e}")
    stripped = src.lstrip()
    if path.endswith((".hcl", ".nomad")) or not stripped.startswith("{"):
        from ..api.codec import encode
        from ..jobspec import JobspecError, parse_job_file

        try:
            return encode(parse_job_file(src, variables))
        except JobspecError as e:
            raise SystemExit(f"error: {path}: {e}")
    if variables:
        raise SystemExit("error: -var only applies to HCL job files")
    try:
        data = json.loads(src)
    except json.JSONDecodeError as e:
        raise SystemExit(f"error: {path} is not valid JSON: {e}")
    return data.get("job", data)


def _parse_var_flags(var_flags) -> dict:
    out = {}
    for spec in var_flags or []:
        key, sep, val = spec.partition("=")
        if not sep:
            raise SystemExit(f"error: -var must be key=value, got {spec!r}")
        try:
            out[key] = json.loads(val)
        except json.JSONDecodeError:
            out[key] = val
    return out


# -- commands ---------------------------------------------------------------
def cmd_agent(args) -> int:
    """Run a dev agent (server+client+HTTP) in the foreground. HCL
    config files (-config, command/agent/config.go) merge over defaults;
    CLI flags override."""
    if not args.dev:
        return _fail("only -dev mode is supported in this build")
    from ..agent import DevAgent
    from ..agent_config import AgentConfig, load_agent_config
    from ..api.http import HTTPAgent

    cfg = AgentConfig()
    if getattr(args, "config", None):
        try:
            cfg = load_agent_config(args.config)
        except Exception as e:  # noqa: BLE001 — config errors are user-facing
            return _fail(f"config: {e}")
    agent = DevAgent(
        device=args.device,
        data_dir=args.data_dir or cfg.data_dir or None,
        num_workers=cfg.server.num_schedulers or 2,
        heartbeat_ttl=cfg.server.heartbeat_ttl_s,
        host_volumes=cfg.client.host_volumes or None,
        driver_mode=cfg.client.driver_mode,
    )
    if cfg.client.gc_max_allocs:
        agent.client.gc_max_terminal_allocs = cfg.client.gc_max_allocs
    if cfg.telemetry.publish_allocation_metrics:
        agent.client.publish_allocation_metrics = True
    agent.start()
    bind = args.bind if args.bind != "127.0.0.1:4646" else (
        f"{cfg.bind_addr}:{cfg.http_port}"
    )
    host, _, port = bind.partition(":")
    http = HTTPAgent(
        agent.server, agent.client, host=host or "127.0.0.1",
        port=int(port or 4646),
    )
    http.start()
    print(f"==> nomad-tpu dev agent running at {http.address}")
    print(f"    node id: {agent.client.node.id}")
    try:
        while True:
            time.sleep(1)
    except KeyboardInterrupt:
        print("==> shutting down")
        http.stop()
        agent.shutdown()
    return 0


def cmd_job_run(args) -> int:
    job = _load_jobfile(args.file, _parse_var_flags(getattr(args, "var", None)))
    c = _client(args)
    try:
        out = c.jobs.register(job)
    except APIException as e:
        return _fail(str(e))
    print(f"==> evaluation {out['eval_id']} created")
    if args.detach:
        return 0
    # poll until the eval completes (command/job_run.go monitor)
    for _ in range(100):
        ev = c.evaluations.info(out["eval_id"])
        if ev["status"] in ("complete", "failed", "canceled"):
            print(f"==> evaluation {out['eval_id']} finished: {ev['status']}")
            if ev.get("failed_tg_allocs"):
                for tg, m in ev["failed_tg_allocs"].items():
                    print(f"    group {tg!r}: placement failed")
                return 2
            return 0
        time.sleep(0.2)
    return _fail("timed out waiting for evaluation")


def cmd_job_plan(args) -> int:
    job = _load_jobfile(args.file, _parse_var_flags(getattr(args, "var", None)))
    c = _client(args)
    try:
        out = c.jobs.plan(job)
    except APIException as e:
        return _fail(str(e))
    print(f"Job: {out['job_id']} ({out['diff_type']}, version {out['version']})")
    for tg, ann in out.get("annotations", {}).items():
        parts = [f"+{ann['place']} place"]
        if ann.get("stop"):
            parts.append(f"-{ann['stop']} stop")
        if ann.get("preemptions"):
            parts.append(f"!{ann['preemptions']} preempt")
        print(f"  group {tg!r}: {', '.join(parts)}")
    if out.get("failed_tg_allocs"):
        print("  WARNING: some allocations would fail to place:")
        for tg, m in out["failed_tg_allocs"].items():
            if isinstance(m, dict):
                detail = []
                dims = m.get("dimension_exhausted") or {}
                if dims:
                    detail.append(
                        "exhausted "
                        + ", ".join(
                            f"{k}={v}" for k, v in sorted(dims.items())
                        )
                    )
                rej = m.get("rejections") or {}
                if rej:
                    detail.append(
                        ", ".join(f"{k}={v}" for k, v in sorted(rej.items()))
                    )
                suffix = f" ({'; '.join(detail)})" if detail else ""
                print(
                    f"    {tg}: {m.get('coalesced_failures', 0)} "
                    f"failure(s){suffix}"
                )
            else:
                print(f"    {tg}: {m}")
    g = out.get("gang")
    if g:
        verdict = (
            "all members place"
            if g.get("feasible")
            else "infeasible — whole gang would release (all-or-nothing)"
        )
        members = ", ".join(
            f"{m}=+{row.get('place', 0)}"
            for m, row in sorted(g.get("members", {}).items())
        )
        print(f"  gang: {verdict} ({members})")
        for r in g.get("reasons", []):
            print(f"    reason: {r}")
    if getattr(args, "verbose", False):
        # -verbose: per-group candidate score tables from the dry run's
        # explain seam (scheduler/annotate.py)
        for tg, group in sorted(
            (out.get("placement_explanations") or {}).items()
        ):
            print(
                f"\nScores for group {tg!r} "
                f"(algorithm {group.get('algorithm', '?')}, "
                f"{group.get('feasible_nodes', 0)}/"
                f"{group.get('nodes_evaluated', 0)} nodes feasible)"
            )
            _render_candidate_table(group)
    return 0


def cmd_job_status(args) -> int:
    c = _client(args)
    if not args.job_id:
        jobs = c.jobs.list()
        if not jobs:
            print("no jobs registered")
            return 0
        print(f"{'ID':<30} {'Type':<10} {'Priority':<9} {'Status':<10}")
        for j in jobs:
            print(f"{j['id']:<30} {j['type']:<10} {j['priority']:<9} {j['status']:<10}")
        return 0
    try:
        job = c.jobs.info(args.job_id)
    except APIException as e:
        return _fail(str(e))
    print(f"ID       = {job['id']}")
    print(f"Name     = {job['name']}")
    print(f"Type     = {job['type']}")
    print(f"Priority = {job['priority']}")
    print(f"Status   = {job['status']}")
    print(f"Version  = {job['version']}")
    summary = c.jobs.summary(args.job_id)["summary"]
    print("\nSummary")
    hdr = f"{'Group':<15} {'Queued':<7} {'Starting':<9} {'Running':<8} {'Complete':<9} {'Failed':<7} {'Lost':<5}"
    print(hdr)
    for tg, s in summary.items():
        print(
            f"{tg:<15} {s.get('queued',0):<7} {s.get('starting',0):<9} "
            f"{s.get('running',0):<8} {s.get('complete',0):<9} "
            f"{s.get('failed',0):<7} {s.get('lost',0):<5}"
        )
    print("\nAllocations")
    print(f"{'ID':<10} {'Node':<10} {'Group':<15} {'Desired':<8} {'Status':<10}")
    for a in c.jobs.allocations(args.job_id):
        print(
            f"{a['id'][:8]:<10} {a['node_id'][:8]:<10} {a['task_group']:<15} "
            f"{a['desired_status']:<8} {a['client_status']:<10}"
        )
    return 0


def cmd_job_stop(args) -> int:
    c = _client(args)
    try:
        out = c.jobs.deregister(args.job_id)
    except APIException as e:
        return _fail(str(e))
    print(f"==> deregistered, evaluation {out.get('eval_id', '')}")
    return 0


def cmd_node_status(args) -> int:
    c = _client(args)
    if args.node_id:
        try:
            n = c.nodes.info(args.node_id)
        except APIException as e:
            return _fail(str(e))
        print(json.dumps(n, indent=2, default=str))
        return 0
    nodes = c.nodes.list()
    print(f"{'ID':<10} {'Name':<20} {'DC':<8} {'Status':<8} {'Eligibility':<12}")
    for n in nodes:
        print(
            f"{n['id'][:8]:<10} {n['name'][:18]:<20} {n['datacenter']:<8} "
            f"{n['status']:<8} {n['scheduling_eligibility']:<12}"
        )
    return 0


def cmd_node_drain(args) -> int:
    c = _client(args)
    try:
        out = c.nodes.drain(args.node_id, enabled=not args.disable)
    except APIException as e:
        return _fail(str(e))
    print(f"==> drain {'disabled' if args.disable else 'enabled'}; evals: {len(out['eval_ids'])}")
    return 0


def cmd_node_eligibility(args) -> int:
    c = _client(args)
    try:
        c.nodes.eligibility(args.node_id, eligible=args.enable)
    except APIException as e:
        return _fail(str(e))
    print("==> eligibility updated")
    return 0


def cmd_alloc_status(args) -> int:
    c = _client(args)
    try:
        a = c.allocations.info(args.alloc_id)
    except APIException as e:
        return _fail(str(e))
    print(f"ID            = {a['id']}")
    print(f"Name          = {a['name']}")
    print(f"Node ID       = {a['node_id']}")
    print(f"Job ID        = {a['job_id']}")
    print(f"Desired       = {a['desired_status']}")
    print(f"Client Status = {a['client_status']}")
    metrics = a.get("metrics") or {}
    if metrics.get("scores"):
        print("\nPlacement Metrics")
        for k, v in metrics["scores"].items():
            print(f"  {k} = {v:.4f}")
        print(f"  nodes evaluated = {metrics.get('nodes_evaluated')}")
    return 0


def cmd_alloc_logs(args) -> int:
    """nomad alloc logs [-stderr] [-f] <alloc_id> [task]
    (command/alloc_logs.go)."""
    c = _client(args)
    try:
        info = c.allocations.info(args.alloc_id)
    except APIException as e:
        return _fail(str(e))
    task = args.task
    if not task:
        tasks = list((info.get("task_states") or {}).keys())
        if len(tasks) == 1:
            task = tasks[0]
        elif not tasks:
            return _fail("allocation has no tasks with state yet; pass a task name")
        else:
            return _fail(f"allocation has multiple tasks, pick one: {tasks}")
    kind = "stderr" if args.stderr else "stdout"
    try:
        for frame in c.allocations.logs(
            info["id"], task, type=kind, follow=args.follow,
            offset=-args.tail if args.tail else 0,  # negative = tail
        ):
            print(frame["data"], end="")
    except KeyboardInterrupt:
        pass
    except APIException as e:
        return _fail(str(e))
    return 0


def cmd_alloc_fs(args) -> int:
    """nomad alloc fs <alloc_id> [path] (command/alloc_fs.go): ls for
    directories, cat for files."""
    c = _client(args)
    try:
        info = c.allocations.info(args.alloc_id)
        path = args.path or "/"
        import json as _json

        try:
            entries = c.allocations.fs_ls(info["id"], path)
            for e in entries:
                kind = "d" if e["is_dir"] else "-"
                print(f"{kind} {e['size']:>10}  {e['name']}")
        except APIException:
            print(c.allocations.fs_cat(info["id"], path), end="")
    except APIException as e:
        return _fail(str(e))
    return 0


def cmd_eval_status(args) -> int:
    c = _client(args)
    try:
        e = c.evaluations.info(args.eval_id)
    except APIException as e2:
        return _fail(str(e2))
    print(json.dumps(e, indent=2, default=str))
    failed = e.get("failed_tg_allocs") or {}
    if failed:
        # structured failure summary: what to drain or resize
        # (AllocMetric.dimension_exhausted / class_exhausted / rejections)
        print("\nFailed Placements")
        for tg, m in sorted(failed.items()):
            if not isinstance(m, dict):
                print(f"  group {tg!r}: placement failed")
                continue
            print(
                f"  group {tg!r}: {m.get('nodes_exhausted', 0)} of "
                f"{m.get('nodes_evaluated', 0)} nodes exhausted "
                f"({m.get('coalesced_failures', 0)} coalesced failures)"
            )
            dims = m.get("dimension_exhausted") or {}
            if dims:
                parts = ", ".join(
                    f"{k}={v}" for k, v in sorted(dims.items())
                )
                print(f"    exhausted dimensions: {parts}")
            classes = m.get("class_exhausted") or {}
            if classes:
                parts = ", ".join(
                    f"{k}={v}" for k, v in sorted(classes.items())
                )
                print(f"    infeasible device classes: {parts}")
            rej = m.get("rejections") or {}
            if rej:
                parts = ", ".join(
                    f"{k}={v}" for k, v in sorted(rej.items())
                )
                print(f"    rejections: {parts}")
    return 0


def _render_candidate_table(group: dict, indent: str = "  ") -> None:
    """Render one group's explanation dict (obs/explain.py
    explanation_to_dict shape) as the `alloc why` / `eval placement`
    candidate table."""
    cands = group.get("top_candidates") or []
    if cands:
        comp_keys = sorted(
            {k for c in cands for k in (c.get("components") or {})}
        )
        print(
            f"{indent}{'Rank':<5} {'Node':<10} {'Final':>9} {'Placed':>7}  "
            + "  ".join(f"{k:>22}" for k in comp_keys)
        )
        for c in cands:
            comps = c.get("components") or {}
            print(
                f"{indent}{c.get('rank', '?'):<5} "
                f"{str(c.get('node_id', ''))[:8]:<10} "
                f"{c.get('final_score', 0.0):>9.4f} {c.get('placed', 0):>7}  "
                + "  ".join(
                    f"{comps[k]:>22.4f}" if k in comps else f"{'-':>22}"
                    for k in comp_keys
                )
            )
    rej = group.get("rejections") or {}
    if rej:
        parts = ", ".join(f"{k}={v}" for k, v in sorted(rej.items()))
        print(f"{indent}rejections: {parts}")
    placed = group.get("placed_nodes") or []
    if placed:
        shown = ", ".join(n[:8] for n in placed[:8])
        more = f" (+{len(placed) - 8} more)" if len(placed) > 8 else ""
        print(f"{indent}placed on: {shown}{more}")


def cmd_alloc_why(args) -> int:
    """nomad-tpu alloc why <alloc>: per-component score provenance for
    one allocation (command analog of AllocMetric/ScoreMetaData)."""
    c = _client(args)
    try:
        out = c.allocations.explain(args.alloc_id)
    except APIException as e:
        return _fail(str(e))
    print(f"Allocation = {out.get('alloc_id', '')}")
    print(f"Job        = {out.get('job_id', '')}")
    print(f"Group      = {out.get('task_group', '')}")
    print(f"Node       = {out.get('node_id', '')}")
    print(f"Eval       = {out.get('eval_id', '')}")
    for sm in out.get("score_meta") or []:
        comps = ", ".join(
            f"{k}={v:.4f}"
            for k, v in sorted((sm.get("scores") or {}).items())
        )
        print(
            f"\nScore ({str(sm.get('node_id', ''))[:8]}) = "
            f"{sm.get('norm_score', 0.0):.4f}"
            + (f"  [{comps}]" if comps else "")
        )
    group = out.get("explanation")
    if group:
        print(
            f"\nCandidates (algorithm {group.get('algorithm', '?')}, "
            f"{group.get('feasible_nodes', 0)}/"
            f"{group.get('nodes_evaluated', 0)} nodes feasible)"
        )
        _render_candidate_table(group)
    elif not out.get("score_meta"):
        print(
            "\nno explanation available (eval aged out of the ring, or "
            "placement_explanations disabled)"
        )
    return 0


def cmd_eval_placement(args) -> int:
    """nomad-tpu eval placement <eval>: per-group candidate tables +
    rejection histograms for one evaluation."""
    c = _client(args)
    try:
        out = c.evaluations.placement(args.eval_id)
    except APIException as e:
        return _fail(str(e))
    print(f"Evaluation = {out.get('eval_id', '')}")
    print(f"Job        = {out.get('job_id', '')}")
    if out.get("source"):
        print(f"Source     = {out['source']}")
    for tg, group in sorted((out.get("groups") or {}).items()):
        algo = group.get("algorithm", "")
        detail = (
            f" (algorithm {algo}, {group.get('feasible_nodes', 0)}/"
            f"{group.get('nodes_evaluated', 0)} nodes feasible)"
            if algo
            else ""
        )
        print(f"\nGroup {tg!r}{detail}")
        _render_candidate_table(group)
    return 0


def cmd_volume_status(args) -> int:
    c = _client(args)
    if getattr(args, "volume_id", None):
        try:
            v = c.volumes.info(args.volume_id)
        except APIException as e:
            return _fail(str(e))
        print(json.dumps(v, indent=2, default=str))
        return 0
    vols = c.volumes.list()
    print(f"{'ID':<20} {'Plugin':<12} {'Access Mode':<26} {'Schedulable':<12} Claims(R/W)")
    for v in vols:
        print(
            f"{v['id'][:18]:<20} {v['plugin_id'][:10]:<12} "
            f"{v['access_mode']:<26} {str(v['schedulable']):<12} "
            f"{v['claims_read']}/{v['claims_write']}"
        )
    return 0


def cmd_volume_register(args) -> int:
    c = _client(args)
    with open(args.file) as f:
        vol = json.load(f)
    if not isinstance(vol, dict):
        return _fail(f"volume spec {args.file!r} must be a JSON object")
    # map Nomad-convention capitalized keys per-key (specs can mix cases)
    camel = {"ID": "id", "Name": "name", "PluginID": "plugin_id",
             "ExternalID": "external_id", "Namespace": "namespace",
             "AccessMode": "access_mode",
             "AttachmentMode": "attachment_mode"}
    vol = {camel.get(k, k): v for k, v in vol.items()}
    if not vol.get("id"):
        return _fail(f"volume spec {args.file!r} has no 'id' field")
    try:
        c.volumes.register(vol)
    except APIException as e:
        return _fail(str(e))
    print(f"Volume {vol['id']!r} registered")
    return 0


def cmd_volume_deregister(args) -> int:
    c = _client(args)
    try:
        c.volumes.deregister(args.volume_id, force=args.force)
    except APIException as e:
        return _fail(str(e))
    print(f"Volume {args.volume_id!r} deregistered")
    return 0


def cmd_plugin_status(args) -> int:
    c = _client(args)
    plugins = c.volumes.plugins()
    print(f"{'ID':<20} {'Healthy Nodes':<14} Healthy Controllers")
    for p in plugins:
        print(
            f"{p['id'][:18]:<20} {p['nodes_healthy']:<14} "
            f"{p['controllers_healthy']}"
        )
    return 0


def cmd_deployment_list(args) -> int:
    c = _client(args)
    deployments = c.deployments.list()
    print(f"{'ID':<10} {'Job':<25} {'Version':<8} {'Status':<12} Description")
    for d in deployments:
        print(
            f"{d['id'][:8]:<10} {d['job_id'][:23]:<25} {d['job_version']:<8} "
            f"{d['status']:<12} {d['status_description']}"
        )
    return 0


def cmd_deployment_status(args) -> int:
    c = _client(args)
    try:
        d = c.deployments.info(args.deployment_id)
    except APIException as e:
        return _fail(str(e))
    print(f"ID          = {d['id']}")
    print(f"Job ID      = {d['job_id']}")
    print(f"Job Version = {d['job_version']}")
    print(f"Status      = {d['status']}")
    print(f"Description = {d['status_description']}")
    print("\nDeployed")
    print(f"{'Group':<15} {'Auto':<6} {'Promoted':<9} {'Desired':<8} {'Canaries':<9} {'Placed':<7} {'Healthy':<8} {'Unhealthy':<9}")
    for name, s in d.get("task_groups", {}).items():
        print(
            f"{name:<15} {str(s['auto_promote']).lower():<6} "
            f"{str(s['promoted']).lower():<9} {s['desired_total']:<8} "
            f"{s['desired_canaries']:<9} {s['placed_allocs']:<7} "
            f"{s['healthy_allocs']:<8} {s['unhealthy_allocs']:<9}"
        )
    return 0


def cmd_deployment_promote(args) -> int:
    c = _client(args)
    try:
        c.deployments.promote(args.deployment_id)
    except APIException as e:
        return _fail(str(e))
    print("==> deployment promoted")
    return 0


def cmd_deployment_fail(args) -> int:
    c = _client(args)
    try:
        c.deployments.fail(args.deployment_id)
    except APIException as e:
        return _fail(str(e))
    print("==> deployment failed")
    return 0


def cmd_deployment_pause(args) -> int:
    """`nomad deployment pause|resume` (command/deployment_pause.go,
    deployment_resume.go)."""
    c = _client(args)
    pause = not getattr(args, "resume", False)
    try:
        c.deployments.pause(args.deployment_id, pause)
    except APIException as e:
        return _fail(str(e))
    print(f"==> deployment {'paused' if pause else 'resumed'}")
    return 0


def cmd_operator_debug(args) -> int:
    """`nomad operator debug` (command/operator_debug.go:54): capture a
    support bundle (metrics, broker/worker/raft stats, thread dump) to a
    file or stdout."""
    c = _client(args)
    bundle = c._request("GET", "/v1/operator/debug")
    if args.output:
        with open(args.output, "w") as f:
            json.dump(bundle, f, indent=2)
        print(f"==> debug bundle written to {args.output}")
    else:
        print(json.dumps(bundle, indent=2))
    return 0


def cmd_job_validate(args) -> int:
    """`nomad job validate` (command/job_validate.go): local admission
    validation of a jobspec file, no server round trip."""
    from ..api.codec import decode_job
    from ..structs.job import validate_job

    payload = _load_jobfile(
        args.file, _parse_var_flags(getattr(args, "var", None))
    )
    try:
        job = decode_job(payload)
        validate_job(job)
    except Exception as e:  # noqa: BLE001 — validation errors surface
        print(f"Job validation errors:\n  * {e}")
        return 1
    print("Job validation successful")
    return 0


def cmd_alloc_stop(args) -> int:
    """`nomad alloc stop` (command/alloc_stop.go): stop + replace one
    allocation."""
    c = _client(args)
    try:
        out = c._request("POST", f"/v1/allocation/{args.alloc_id}/stop")
    except APIException as e:
        return _fail(str(e))
    print(f"==> alloc {args.alloc_id[:8]} stopping "
          f"(eval {out['eval_id'][:8]})")
    return 0


def cmd_job_history(args) -> int:
    """`nomad job history` (command/job_history.go)."""
    c = _client(args)
    out = c._request("GET", f"/v1/job/{args.job_id}/versions")
    for v in out.get("versions", []):
        stable = "stable" if v.get("stable") else ""
        print(
            f"Version {v.get('version', 0):>3}  "
            f"priority={v.get('priority', 50)}  {stable}"
        )
    return 0


def cmd_job_inspect(args) -> int:
    """`nomad job inspect` (command/job_inspect.go): raw job JSON."""
    c = _client(args)
    out = c._request("GET", f"/v1/job/{args.job_id}")
    print(json.dumps(out, indent=2, default=str))
    return 0


def cmd_job_revert(args) -> int:
    """`nomad job revert <job> <version>` (command/job_revert.go)."""
    c = _client(args)
    out = c._request(
        "POST",
        f"/v1/job/{args.job_id}/revert",
        body={"job_version": int(args.version)},
    )
    print(
        f"==> reverted {args.job_id} to version {out['reverted_to']} "
        f"(eval {out.get('eval_id', '')[:8]})"
    )
    return 0


def cmd_job_eval(args) -> int:
    """`nomad job eval` (command/job_eval.go): force a re-evaluation."""
    c = _client(args)
    out = c._request("POST", f"/v1/job/{args.job_id}/evaluate")
    print(f"==> created evaluation {out['eval_id'][:8]}")
    return 0


def cmd_job_dispatch(args) -> int:
    """`nomad job dispatch` (command/job_dispatch.go)."""
    c = _client(args)
    meta = dict(kv.split("=", 1) for kv in (args.meta or []))
    out = c.jobs.dispatch(
        args.job_id, payload=(args.payload or "").encode(), meta=meta
    )
    print(f"==> dispatched {out.get('dispatched_job_id', '')}")
    return 0


def cmd_job_periodic_force(args) -> int:
    """`nomad job periodic force` (command/job_periodic_force.go)."""
    c = _client(args)
    out = c._request("POST", f"/v1/job/{args.job_id}/periodic/force")
    print(f"==> forced periodic launch, eval {out.get('eval_id', '')[:8]}")
    return 0


def cmd_eval_list(args) -> int:
    """`nomad eval list` (command/eval_list.go)."""
    c = _client(args)
    evs = c._request("GET", "/v1/evaluations")
    rows = [("ID", "Priority", "Type", "TriggeredBy", "Job", "Status")]
    for e in evs[:50]:
        rows.append((
            e.get("id", "")[:8], str(e.get("priority", "")),
            e.get("type", ""), e.get("triggered_by", ""),
            e.get("job_id", ""), e.get("status", ""),
        ))
    w = [max(len(r[i]) for r in rows) for i in range(6)]
    for r in rows:
        print("  ".join(v.ljust(x) for v, x in zip(r, w)))
    return 0


def cmd_system_gc(args) -> int:
    """`nomad system gc` (command/system_gc.go)."""
    c = _client(args)
    out = c._request("PUT", "/v1/system/gc")
    print("==> gc:", json.dumps(out.get("reaped", {})))
    return 0


def cmd_operator_snapshot_save(args) -> int:
    """`nomad operator snapshot save` (command/operator_snapshot_save.go)."""
    c = _client(args)
    out = c._request(
        "POST", "/v1/operator/snapshot/save", body={"path": args.path}
    )
    print(f"==> snapshot at index {out['index']} written to {out['path']}")
    return 0


def cmd_operator_metrics(args) -> int:
    """`nomad operator metrics` (command/operator_metrics.go)."""
    c = _client(args)
    print(json.dumps(c._request("GET", "/v1/metrics"), indent=2))
    return 0


def cmd_trace(args) -> int:
    """`nomad-tpu trace [eval_id]` — flight-recorder view. Without an
    id: recent completed traces + last error events. With one: the full
    span tree rendered as an indented duration breakdown."""
    c = _client(args)
    if args.eval_id:
        try:
            tr = c._request("GET", f"/v1/agent/trace/{args.eval_id}")
        except APIException as e:
            return _fail(str(e))
        if args.json:
            print(json.dumps(tr, indent=2))
        else:
            from ..obs.recorder import render_trace

            print(render_trace(tr))
        return 0
    out = c._request("GET", "/v1/agent/trace")
    if args.json:
        print(json.dumps(out, indent=2))
        return 0
    traces = out.get("traces", [])
    if not traces:
        print("no completed traces recorded")
    for t in traces:
        print(
            f"{t['eval_id']}  {t['status']:<7} "
            f"{t['duration_ms']:>9.2f}ms  {t['spans']:>3} spans  "
            + ",".join(f"{k}={v}" for k, v in sorted(t["tags"].items()))
        )
    errors = out.get("errors", [])
    if errors:
        print(f"\n{len(errors)} recent error event(s):")
        for ev in errors[:10]:
            tail = f"  eval={ev['eval_id']}" if ev.get("eval_id") else ""
            print(f"  [{ev['component']}] {ev['error']}{tail}")
    return 0


def cmd_resilience_status(args) -> int:
    """`nomad-tpu resilience status` — per-kernel circuit-breaker
    states, the forced-open override, recent trip events, and the
    resilience counters (/v1/agent/resilience)."""
    c = _client(args)
    try:
        out = c._request("GET", "/v1/agent/resilience")
    except APIException as e:
        return _fail(str(e))
    if args.json:
        print(json.dumps(out, indent=2))
        return 0
    breakers = out.get("breakers", {})
    if out.get("forced_open"):
        print("forced open: ALL kernels routed to the reference path")
    if not breakers:
        print("no kernel breakers registered (no kernel has run yet)")
    for name in sorted(breakers):
        b = breakers[name]
        extra = ""
        if b["state"] != "closed":
            extra = (
                f"  probe_in={b.get('probe_in_s', 0.0):.1f}s"
                f"  last_error={b.get('last_error') or '-'}"
            )
        print(
            f"{name:<40} {b['state']:<9} trips={b['trips']:<3} "
            f"consecutive_failures={b['consecutive_failures']}{extra}"
        )
    trips = out.get("recent_trips", [])
    if trips:
        print(f"\n{len(trips)} recent trip event(s):")
        for ev in trips[:10]:
            print(f"  [{ev['component']}] {ev['error']}")
    lanes = out.get("lanes", {})
    if lanes.get("lane_mode"):
        claims = lanes.get("claims", {})
        print(
            f"\nlanes: {lanes['num_lanes']} across "
            f"{lanes['num_batch_workers']} batch worker(s)"
        )
        for w in sorted(lanes.get("assignments", {}), key=int):
            owned = lanes["assignments"][w]
            print(f"  worker {w}: lanes {','.join(map(str, owned))}")
        if claims:
            cc = claims.get("counters", {})
            print(
                f"  handoffs: reserves={cc.get('reserves', 0)} "
                f"confirms={cc.get('confirms', 0)} "
                f"rejected={cc.get('confirm_rejected', 0)} "
                f"active={claims.get('active_claims', 0)}"
            )
    adm = out.get("admission")
    if adm:
        sig = adm.get("signals") or {}
        print(
            f"\nadmission: level={adm['level']} "
            f"since={adm.get('since_s', 0.0):.1f}s "
            f"changes={adm.get('level_changes', 0)}"
            + (" (forced)" if adm.get("forced") else "")
        )
        print(
            f"  signals: backlog={sig.get('backlog', 0)} "
            f"p99={sig.get('p99_ms', 0.0):.1f}ms "
            f"arrival={sig.get('arrival_rate', 0.0):.1f}/s "
            f"completion={sig.get('completion_rate', 0.0):.1f}/s"
        )
        for tier in ("high", "normal", "low"):
            c = (adm.get("counters") or {}).get(tier)
            if c and c.get("submitted"):
                print(
                    f"  {tier:<7} submitted={c['submitted']} "
                    f"admitted={c['admitted']} deferred={c['deferred']} "
                    f"shed={c['shed']}"
                )
    counters = out.get("counters", {})
    if counters:
        print("\ncounters:")
        for k in sorted(counters):
            print(f"  {k} = {counters[k]}")
    return 0


def cmd_slo_report(args) -> int:
    """`nomad-tpu slo report` — the live SLO report from
    /v1/agent/slo: eval/placement latency percentiles (always-on, fed
    by the flight recorder), queue depth, resilience/lane counters,
    ring coverage, and the verdict against declared targets."""
    c = _client(args)
    params = {}
    if args.eval_p99_ms is not None:
        params["eval_p99_ms"] = args.eval_p99_ms
    if args.placement_p99_ms is not None:
        params["placement_p99_ms"] = args.placement_p99_ms
    qs = "&".join(f"{k}={v}" for k, v in params.items())
    try:
        out = c._request("GET", "/v1/agent/slo" + (f"?{qs}" if qs else ""))
    except APIException as e:
        return _fail(str(e))
    if args.json:
        print(json.dumps(out, indent=2))
        return 0
    slo = out.get("slo", {})
    targets = out.get("targets", {})
    for key, label in (
        ("eval_latency_ms", "eval latency"),
        ("placement_latency_ms", "placement"),
        ("plan_apply_ms", "plan apply"),
    ):
        s = slo.get(key, {})
        print(
            f"{label:<14} p50={s.get('p50_ms', 0.0):>9.2f}ms "
            f"p95={s.get('p95_ms', 0.0):>9.2f}ms "
            f"p99={s.get('p99_ms', 0.0):>9.2f}ms "
            f"max={s.get('max_ms', 0.0):>9.2f}ms "
            f"(n={s.get('count', 0)})"
        )
    q = slo.get("queue_depth", {})
    print(f"queue depth    now={q.get('max', 0.0):.0f}")
    cov = slo.get("ring_coverage", {})
    print(
        f"trace ring     recorded={cov.get('traces_recorded', 0)} "
        f"evicted={cov.get('traces_evicted', 0)} "
        f"coverage={cov.get('coverage', 1.0):.2%}"
    )
    ctr = slo.get("counters", {})
    nonzero = {k: v for k, v in sorted(ctr.items()) if v}
    if nonzero:
        print("counters:")
        for k, v in nonzero.items():
            print(f"  {k} = {int(v)}")
    v = slo.get("verdict", {})
    if v.get("pass"):
        print("SLO PASS")
        return 0
    print("SLO FAIL:")
    for f in v.get("failures", ()):
        print(f"  {f}")
    checked = {k: t for k, t in targets.items() if t is not None}
    print("targets: " + " ".join(f"{k}={t:g}" for k, t in checked.items()))
    return 1


def cmd_calibrate_status(args) -> int:
    """`nomad-tpu calibrate status` — one-screen calibration summary
    from /v1/agent/calibration: constants by provenance, the loaded
    probe artifact, learned estimator cells, throughput source."""
    c = _client(args)
    try:
        out = c._request("GET", "/v1/agent/calibration")
    except APIException as e:
        return _fail(str(e))
    if args.json:
        print(json.dumps(out, indent=2))
        return 0
    table = out.get("table", {})
    by_source = table.get("by_source", {})
    print(
        f"constants: {len(table.get('constants', {}))} "
        f"(default={by_source.get('default', 0)} "
        f"probe={by_source.get('probe', 0)} "
        f"learned={by_source.get('learned', 0)})"
    )
    probe = table.get("probe")
    if probe:
        print(
            f"probe artifact: rate={probe.get('rate_evals_per_s', 0.0):g}/s "
            f"seed={probe.get('seed', 0)} nodes={probe.get('nodes', 0)} "
            f"window={probe.get('probe_seconds', 0.0):g}s"
        )
    else:
        print("probe artifact: none loaded")
    est = out.get("estimator", {})
    print(
        f"estimator: cells={est.get('cell_count', 0)} "
        f"learned={est.get('learned_cells', 0)} "
        f"samples={est.get('samples', 0)} "
        f"dropped={est.get('dropped', 0)}"
    )
    print(f"throughput source: {out.get('throughput_source', 'declared')}")
    return 0


def cmd_calibrate_report(args) -> int:
    """`nomad-tpu calibrate report` — the full calibration plane: every
    constant with value/source/provenance and every learned
    per-(device class × job profile) throughput cell."""
    c = _client(args)
    try:
        out = c._request("GET", "/v1/agent/calibration")
    except APIException as e:
        return _fail(str(e))
    if args.json:
        print(json.dumps(out, indent=2))
        return 0
    constants = (out.get("table") or {}).get("constants", {})
    print(f"{'constant':<36} {'value':>12} {'source':<8} samples window")
    for name in sorted(constants):
        e = constants[name]
        print(
            f"{name:<36} {e.get('value', 0.0):>12g} "
            f"{e.get('source', '?'):<8} "
            f"{e.get('samples', 0):>7} {e.get('window') or '-'}"
        )
    cells = (out.get("estimator") or {}).get("cells", {})
    if cells:
        print(
            f"\n{'device class × profile':<36} {'ema':>10} "
            f"{'p50':>10} {'conf':>6} samples source"
        )
        for key in sorted(cells):
            cell = cells[key]
            print(
                f"{key:<36} {cell.get('ema', 0.0):>10.3f} "
                f"{cell.get('p50', 0.0):>10.3f} "
                f"{cell.get('confidence', 0.0):>6.2f} "
                f"{cell.get('samples', 0):>7} {cell.get('source', '?')}"
            )
    else:
        print("\nno learned throughput cells yet")
    print(f"\nthroughput source: {out.get('throughput_source', 'declared')}")
    return 0


def cmd_scaling_policies(args) -> int:
    """`nomad scaling policy list` (command/scaling_policy_list.go)."""
    c = _client(args)
    print(json.dumps(c._request("GET", "/v1/scaling/policies"), indent=2))
    return 0


def cmd_acl_bootstrap(args) -> int:
    c = _client(args)
    out = c._request("POST", "/v1/acl/bootstrap")
    print(f"Accessor ID = {out['AccessorID']}")
    print(f"Secret ID   = {out['SecretID']}")
    return 0


def cmd_acl_policy_apply(args) -> int:
    c = _client(args)
    rules = open(args.rules_file).read()
    c._request(
        "POST", f"/v1/acl/policy/{args.name}", body={"Rules": rules}
    )
    print(f"==> wrote policy {args.name}")
    return 0


def cmd_acl_policy_list(args) -> int:
    c = _client(args)
    for p in c._request("GET", "/v1/acl/policies"):
        print(p.get("Name", p.get("name", "")))
    return 0


def cmd_acl_policy_delete(args) -> int:
    c = _client(args)
    c._request("DELETE", f"/v1/acl/policy/{args.name}")
    print(f"==> deleted policy {args.name}")
    return 0


def cmd_acl_token_create(args) -> int:
    c = _client(args)
    out = c._request(
        "POST",
        "/v1/acl/token",
        body={
            "Name": args.name,
            "Type": args.type,
            "Policies": args.policy or [],
        },
    )
    print(f"Accessor ID = {out['AccessorID']}")
    print(f"Secret ID   = {out['SecretID']}")
    return 0


def cmd_acl_token_list(args) -> int:
    c = _client(args)
    for t in c._request("GET", "/v1/acl/tokens"):
        print(
            f"{t.get('AccessorID', '')[:8]}  {t.get('Type', ''):<10} "
            f"{t.get('Name', '')}"
        )
    return 0


def cmd_acl_token_delete(args) -> int:
    c = _client(args)
    c._request("DELETE", f"/v1/acl/token/{args.accessor}")
    print(f"==> deleted token {args.accessor}")
    return 0


def cmd_version(args) -> int:
    import nomad_tpu_torch

    print(f"nomad-tpu v{nomad_tpu_torch.__version__}")
    return 0


def cmd_chaos_run(args) -> int:
    """`nomad-tpu chaos run` — deterministic fault-injection run against
    an in-process cluster (nomad_tpu_torch.chaos). Deliberately NOT behind the
    HTTP boundary: chaos needs to reach inside the broker/applier seams,
    so it boots its own single-server cluster rather than dialing an
    agent. Exit 0 on a clean invariant report, 1 on any violation."""
    from ..chaos import FAULT_KINDS, run_chaos, shrink_schedule

    faults = tuple(args.faults.split("+")) if args.faults else FAULT_KINDS
    unknown = [f for f in faults if f not in FAULT_KINDS]
    if unknown:
        return _fail(
            f"unknown fault kind(s) {'+'.join(unknown)}; "
            f"choose from {'+'.join(FAULT_KINDS)}"
        )
    run = run_chaos(
        seed=args.seed,
        steps=args.steps,
        faults=faults,
        nodes=args.nodes,
        rate=args.rate,
        num_batch_workers=args.batch_workers,
        device=args.device,
    )
    if args.json:
        print(run.canonical_json())
    else:
        print(run.render(verbose=args.verbose))
    if run.ok:
        return 0
    if args.shrink:
        print("shrinking failing schedule...", file=sys.stderr)
        minimal, fail = shrink_schedule(
            seed=args.seed,
            steps=args.steps,
            faults=faults,
            nodes=args.nodes,
            rate=args.rate,
            num_batch_workers=args.batch_workers,
            log=lambda m: print(m, file=sys.stderr),
            device=args.device,
        )
        if fail is None:
            print("failure did not reproduce under shrink", file=sys.stderr)
        else:
            print(f"minimal failing schedule ({len(minimal)} faults):")
            for spec in minimal:
                print(f"  {spec.row()}")
    return 1


def cmd_analyze_kernels(args) -> int:
    """`nomad-tpu analyze kernels` — the kernel lint over the port's
    hand-written fleet (``analysis/kernellint``), on ``--device`` (the
    card by default; without CUDA it raises unless ``--device cpu``).
    In-process (not behind the HTTP boundary): the fleet runs where the
    kernels are importable. Exit 0 when every finding is baselined, 1 on
    any new finding or failed invariance proof."""
    from ..analysis.kernellint import engine

    code, new, fixed, reports = engine.run_kernellint(
        fix_baseline=args.fix_baseline, device=args.device,
    )
    diff_report = None
    if args.diff:
        from ..analysis.kernellint.diff import prove_all

        diff_report = prove_all(args.device)
        code = code or (0 if diff_report["ok"] else 1)

    if args.json:
        print(json.dumps({
            "kernels": {
                name: r | {"fingerprints": r["configs"]}
                for name, r in reports.items()
            },
            "new": [
                f.__dict__ | {"fingerprint": f.fingerprint} for f in new
            ],
            "fixed": sorted(fixed),
            "diff": diff_report,
        }, indent=2, default=str))
        return code

    rows = [("Kernel", "Route", "Calls", "Builds", "Budget", "Findings", "Fingerprints")]
    for name, r in sorted(reports.items()):
        rows.append((
            name, r["route"], str(r["calls"]), str(r["builds"]),
            str(r["build_budget"]), str(r["findings"]),
            "; ".join(
                f"{label}: {fp}" for label, fp in sorted(r["configs"].items())
            ) or "-",
        ))
    w = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
    for r in rows:
        print("  ".join(v.ljust(x) for v, x in zip(r, w)))
    for f in new:
        print(f.render())
    if fixed:
        print(
            f"note: {len(fixed)} baselined finding(s) no longer fire — "
            "run --fix-baseline to tighten the ratchet"
        )
    if diff_report is not None:
        for key in ("explain", "incremental", "mesh"):
            rep = diff_report[key]
            print(f"invariant [{'OK' if rep['ok'] else 'FAIL'}] {rep['claim']}")
    print(
        f"{len(new)} new finding(s) across {len(reports)} kernel(s)"
    )
    return code


def cmd_operator_raft_list(args) -> int:
    """`nomad operator raft list-peers`
    (command/operator_raft_list.go)."""
    c = _client(args)
    cfg = c._request("GET", "/v1/operator/raft/configuration")
    rows = [("ID", "Address", "State", "Voter")]
    for s in cfg.get("servers", []):
        rows.append((
            s["id"],
            s["address"],
            "leader" if s.get("leader") else "follower",
            "true" if s.get("voter") else "false",
        ))
    widths = [max(len(r[i]) for r in rows) for i in range(4)]
    for r in rows:
        print("  ".join(v.ljust(w) for v, w in zip(r, widths)))
    return 0


def cmd_operator_raft_remove(args) -> int:
    """`nomad operator raft remove-peer -peer-id=<id>`
    (command/operator_raft_remove.go)."""
    c = _client(args)
    c._request(
        "DELETE", "/v1/operator/raft/peer", params={"id": args.peer_id}
    )
    print(f"==> removed raft peer {args.peer_id}")
    return 0


def cmd_operator_defrag(args) -> int:
    """`nomad-tpu operator defrag [--trigger|--pause|--resume]` — the
    live-migration control plane: status/counters by default, or poke
    the controller (server/defrag.py)."""
    c = _client(args)
    if args.pause or args.resume:
        st = c._request(
            "POST", "/v1/operator/defrag", body={"paused": bool(args.pause)}
        )
        print(f"==> defrag {'paused' if st['paused'] else 'resumed'}")
    elif args.trigger:
        st = c._request("POST", "/v1/operator/defrag", body={})
        print("==> defrag cycle triggered")
    else:
        st = c._request("GET", "/v1/operator/defrag")
    mode = "continuous" if st.get("enabled") else "on-demand"
    if st.get("paused"):
        mode += " (paused)"
    print(f"==> defrag: {mode}  interval={st.get('interval')}s  "
          f"budget={st.get('budget')} moves/cycle")
    print(f"    packing efficiency: {st.get('packing_efficiency')}")
    print(f"    cycles with moves:  {st.get('cycles')}")
    for k, v in sorted((st.get("counters") or {}).items()):
        print(f"    {k}: {v:g}")
    return 0


def cmd_operator_scheduler(args) -> int:
    c = _client(args)
    if args.algorithm:
        c.operator.set_scheduler_config(scheduler_algorithm=args.algorithm)
        print(f"==> scheduler algorithm set to {args.algorithm}")
    cfg = c.operator.scheduler_config()
    print(json.dumps(cfg, indent=2))
    return 0


def cmd_operator_placements(args) -> int:
    """`nomad operator placements` — live per-device-class allocation
    counts and the active algorithm (heterogeneity observability)."""
    c = _client(args)
    rep = c._request("GET", "/v1/operator/scheduler/placements")
    print(f"==> scheduler algorithm: {rep['scheduler_algorithm']}")
    print(f"{'Device Class':<16} {'Nodes':>6} {'Allocs':>7}")
    allocs = rep.get("allocs_per_class", {})
    for dc, n in sorted(rep.get("nodes_per_class", {}).items()):
        label = dc or "(class-less)"
        print(f"{label:<16} {n:>6} {allocs.get(dc, 0):>7}")
    jobs = rep.get("jobs", {})
    if jobs:
        print("\nPer job:")
        for jk, classes in jobs.items():
            parts = ", ".join(
                f"{dc or '(class-less)'}={cnt}"
                for dc, cnt in classes.items()
            )
            print(f"  {jk}: {parts}")
    topo = rep.get("topology", {})
    for level in ("racks", "pods"):
        rows = topo.get(level, {})
        # a single "" bucket means the fleet carries no coordinates at
        # this level — nothing to show
        if not rows or set(rows) == {""}:
            continue
        print(f"\n{level.capitalize():<16} {'Nodes':>6} {'Allocs':>7}")
        for name, row in sorted(rows.items()):
            label = name or "(none)"
            print(
                f"{label:<16} {row.get('nodes', 0):>6} "
                f"{row.get('allocs', 0):>7}"
            )
    gangs = rep.get("gangs", {})
    if gangs:
        print("\nGangs:")
        for jk, g in sorted(gangs.items()):
            state = "intact" if g.get("intact") else "released"
            parts = ", ".join(
                f"{m}={cnt}/{g.get('desired', {}).get(m, 0)}"
                for m, cnt in sorted(g.get("members", {}).items())
            )
            print(f"  {jk}: {state} ({parts})")
    return 0


def cmd_namespace(args) -> int:
    c = _client(args)
    try:
        if args.ns_cmd == "list":
            for n in c.namespaces.list():
                print(f"{n['name']:<20} {n.get('description','')}")
        elif args.ns_cmd == "apply":
            c.namespaces.apply(args.name, args.description or "")
            print(f"namespace {args.name!r} applied")
        elif args.ns_cmd == "delete":
            c.namespaces.delete(args.name)
            print(f"namespace {args.name!r} deleted")
        elif args.ns_cmd == "status":
            print(json.dumps(c.namespaces.info(args.name), indent=2))
    except APIException as e:
        return _fail(str(e))
    return 0


def cmd_job_scale(args) -> int:
    """nomad job scale <job> [group] <count> (command/job_scale.go)."""
    sa = args.scale_args
    if len(sa) == 2:
        job_id, group, count_s = sa[0], None, sa[1]
    elif len(sa) == 3:
        job_id, group, count_s = sa
    else:
        return _fail("usage: job scale <job> [group] <count>")
    try:
        count = int(count_s)
    except ValueError:
        return _fail(f"count must be an integer, got {count_s!r}")
    args.job_id, args.count = job_id, count
    c = _client(args)
    if group is None:
        try:
            info = c.jobs.info(args.job_id)
        except APIException as e:
            return _fail(str(e))
        tgs = [tg["name"] for tg in info.get("task_groups", [])]
        if len(tgs) != 1:
            return _fail(f"job has multiple groups, pick one: {tgs}")
        group = tgs[0]
    try:
        out = c.jobs.scale(args.job_id, group, args.count)
    except APIException as e:
        return _fail(str(e))
    print(f"==> scaled {args.job_id}/{group} to {args.count}; "
          f"evaluation {out['eval_id']}")
    return 0


def cmd_status(args) -> int:
    """nomad status <prefix>: cross-context search dispatch
    (command/status.go + search_endpoint.go)."""
    c = _client(args)
    try:
        if not args.prefix:
            return cmd_job_status(argparse.Namespace(
                address=args.address, job_id=None))
        res = c.search(args.prefix)
        hits = [(ctx, m) for ctx, ms in res["matches"].items() for m in ms]
        if not hits:
            return _fail(f"no matches for {args.prefix!r}")
        if len(hits) > 1:
            print(f"multiple matches for {args.prefix!r}:")
            for ctx, m in hits:
                print(f"  {ctx[:-1]:<12} {m}")
            return 0
        ctx, m = hits[0]
        ns = argparse.Namespace(address=args.address)
        if ctx == "jobs":
            ns.job_id = m
            return cmd_job_status(ns)
        if ctx == "nodes":
            ns.node_id = m
            return cmd_node_status(ns)
        if ctx == "allocs":
            ns.alloc_id = m
            return cmd_alloc_status(ns)
        if ctx == "evals":
            ns.eval_id = m
            return cmd_eval_status(ns)
        print(f"{ctx[:-1]}: {m}")
    except APIException as e:
        return _fail(str(e))
    return 0


def cmd_server_members(args) -> int:
    c = _client(args)
    info = c.agent.self()
    print(json.dumps(info, indent=2))
    return 0


# -- parser -----------------------------------------------------------------
class _AlgorithmChoices:
    """The registered scheduler algorithms as argparse ``choices``, read
    from the registry only when ``--algorithm`` is given (its ``metavar``
    keeps argparse from listing them when it builds the parser): the
    registry imports the scheduler and PyTorch, which a command that only
    speaks HTTP does not need."""

    def _names(self):
        from ..scheduler.algorithms import available

        return available()

    def __contains__(self, name):
        return name in self._names()

    def __iter__(self):
        return iter(self._names())


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="nomad-tpu")
    p.add_argument("-address", "--address", default=DEFAULT_ADDR)
    p.add_argument(
        "-token", "--token",
        default=os.environ.get("NOMAD_TOKEN", ""),
        help="ACL secret (or env NOMAD_TOKEN)",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    agent = sub.add_parser("agent", help="run an agent")
    agent.add_argument("-dev", action="store_true", dest="dev")
    agent.add_argument("--data-dir", default="")
    agent.add_argument("--bind", default="127.0.0.1:4646")
    agent.add_argument(
        "--device", default="cuda",
        help="where the server's kernels run: cuda (default) or cpu",
    )
    agent.add_argument(
        "-config", action="append", dest="config", default=[],
        help="HCL agent config file (repeatable; merged in order)",
    )
    agent.set_defaults(fn=cmd_agent)

    job = sub.add_parser("job", help="job commands").add_subparsers(
        dest="sub", required=True
    )
    run = job.add_parser("run")
    run.add_argument("file")
    run.add_argument("-detach", action="store_true")
    run.add_argument("-var", action="append", dest="var", metavar="key=value")
    run.set_defaults(fn=cmd_job_run)
    plan = job.add_parser("plan")
    plan.add_argument("file")
    plan.add_argument("-var", action="append", dest="var", metavar="key=value")
    plan.add_argument(
        "-verbose", action="store_true", dest="verbose",
        help="show per-group candidate score tables",
    )
    plan.set_defaults(fn=cmd_job_plan)
    status = job.add_parser("status")
    status.add_argument("job_id", nargs="?")
    status.set_defaults(fn=cmd_job_status)
    scale = job.add_parser("scale")
    scale.add_argument("scale_args", nargs="+",
                       metavar="job [group] count")
    scale.set_defaults(fn=cmd_job_scale)
    stop = job.add_parser("stop")
    stop.add_argument("job_id")
    stop.set_defaults(fn=cmd_job_stop)
    hist = job.add_parser("history")
    hist.add_argument("job_id")
    hist.set_defaults(fn=cmd_job_history)
    insp = job.add_parser("inspect")
    insp.add_argument("job_id")
    insp.set_defaults(fn=cmd_job_inspect)
    rev = job.add_parser("revert")
    rev.add_argument("job_id")
    rev.add_argument("version")
    rev.set_defaults(fn=cmd_job_revert)
    jeval = job.add_parser("eval")
    jeval.add_argument("job_id")
    jeval.set_defaults(fn=cmd_job_eval)
    disp = job.add_parser("dispatch")
    disp.add_argument("job_id")
    disp.add_argument("--payload", default="")
    disp.add_argument("--meta", action="append", metavar="key=value")
    disp.set_defaults(fn=cmd_job_dispatch)
    pforce = job.add_parser("periodic-force")
    pforce.add_argument("job_id")
    pforce.set_defaults(fn=cmd_job_periodic_force)
    jval = job.add_parser("validate")
    jval.add_argument("file")
    jval.add_argument("-var", action="append", dest="var", metavar="key=value")
    jval.set_defaults(fn=cmd_job_validate)

    node = sub.add_parser("node", help="node commands").add_subparsers(
        dest="sub", required=True
    )
    nstatus = node.add_parser("status")
    nstatus.add_argument("node_id", nargs="?")
    nstatus.set_defaults(fn=cmd_node_status)
    drain = node.add_parser("drain")
    drain.add_argument("node_id")
    drain.add_argument("-disable", action="store_true")
    drain.set_defaults(fn=cmd_node_drain)
    elig = node.add_parser("eligibility")
    elig.add_argument("node_id")
    elig.add_argument("-enable", action="store_true")
    elig.set_defaults(fn=cmd_node_eligibility)

    alloc = sub.add_parser("alloc", help="alloc commands").add_subparsers(
        dest="sub", required=True
    )
    alogs = alloc.add_parser("logs")
    alogs.add_argument("alloc_id")
    alogs.add_argument("task", nargs="?", default=None)
    alogs.add_argument("-stderr", dest="stderr", action="store_true")
    alogs.add_argument("-f", dest="follow", action="store_true")
    alogs.add_argument("-tail", dest="tail", type=int, default=0)
    alogs.set_defaults(fn=cmd_alloc_logs)
    afs = alloc.add_parser("fs")
    afs.add_argument("alloc_id")
    afs.add_argument("path", nargs="?", default="/")
    afs.set_defaults(fn=cmd_alloc_fs)
    astop = alloc.add_parser("stop")
    astop.add_argument("alloc_id")
    astop.set_defaults(fn=cmd_alloc_stop)
    astatus = alloc.add_parser("status")
    astatus.add_argument("alloc_id")
    astatus.set_defaults(fn=cmd_alloc_status)
    awhy = alloc.add_parser(
        "why", help="score provenance: why the alloc landed on its node"
    )
    awhy.add_argument("alloc_id")
    awhy.set_defaults(fn=cmd_alloc_why)

    ev = sub.add_parser("eval", help="eval commands").add_subparsers(
        dest="sub", required=True
    )
    estatus = ev.add_parser("status")
    estatus.add_argument("eval_id")
    estatus.set_defaults(fn=cmd_eval_status)
    elist = ev.add_parser("list")
    elist.set_defaults(fn=cmd_eval_list)
    eplace = ev.add_parser(
        "placement", help="per-group candidate tables for an eval"
    )
    eplace.add_argument("eval_id")
    eplace.set_defaults(fn=cmd_eval_placement)

    dep = sub.add_parser("deployment", help="deployment commands").add_subparsers(
        dest="sub", required=True
    )
    dlist = dep.add_parser("list")
    dlist.set_defaults(fn=cmd_deployment_list)
    dstatus = dep.add_parser("status")
    dstatus.add_argument("deployment_id")
    dstatus.set_defaults(fn=cmd_deployment_status)
    dpromote = dep.add_parser("promote")
    dpromote.add_argument("deployment_id")
    dpromote.set_defaults(fn=cmd_deployment_promote)
    dfail = dep.add_parser("fail")
    dfail.add_argument("deployment_id")
    dfail.set_defaults(fn=cmd_deployment_fail)
    dpause = dep.add_parser("pause")
    dpause.add_argument("deployment_id")
    dpause.set_defaults(fn=cmd_deployment_pause, resume=False)
    dresume = dep.add_parser("resume")
    dresume.add_argument("deployment_id")
    dresume.set_defaults(fn=cmd_deployment_pause, resume=True)

    vol = sub.add_parser("volume", help="volume commands").add_subparsers(
        dest="sub", required=True
    )
    vstatus = vol.add_parser("status")
    vstatus.add_argument("volume_id", nargs="?")
    vstatus.set_defaults(fn=cmd_volume_status)
    vreg = vol.add_parser("register")
    vreg.add_argument("file", help="volume spec JSON file")
    vreg.set_defaults(fn=cmd_volume_register)
    vdereg = vol.add_parser("deregister")
    vdereg.add_argument("volume_id")
    vdereg.add_argument("-force", action="store_true")
    vdereg.set_defaults(fn=cmd_volume_deregister)

    plugin = sub.add_parser("plugin", help="plugin commands").add_subparsers(
        dest="sub", required=True
    )
    pstatus = plugin.add_parser("status")
    pstatus.set_defaults(fn=cmd_plugin_status)

    op = sub.add_parser("operator", help="operator commands").add_subparsers(
        dest="sub", required=True
    )
    sched = op.add_parser("scheduler")
    sched.add_argument(
        "--algorithm", choices=_AlgorithmChoices(), metavar="ALGORITHM",
        help="a registered scheduler algorithm (binpack, spread, hetero-*, cp-*)",
    )
    sched.set_defaults(fn=cmd_operator_scheduler)
    placements = op.add_parser(
        "placements",
        help="per-device-class and per-rack/pod allocation counts, "
             "plus gang intactness",
    )
    placements.set_defaults(fn=cmd_operator_placements)
    dbg = op.add_parser("debug", help="capture a support bundle")
    dbg.add_argument("--output", "-o", default="")
    dbg.set_defaults(fn=cmd_operator_debug)
    raft = op.add_parser("raft", help="raft operator commands").add_subparsers(
        dest="raft_cmd", required=True
    )
    rlist = raft.add_parser("list-peers")
    rlist.set_defaults(fn=cmd_operator_raft_list)
    rrem = raft.add_parser("remove-peer")
    rrem.add_argument("--peer-id", dest="peer_id", required=True)
    rrem.set_defaults(fn=cmd_operator_raft_remove)
    osnap = op.add_parser("snapshot", help="snapshot commands").add_subparsers(
        dest="snap_cmd", required=True
    )
    osave = osnap.add_parser("save")
    osave.add_argument("path")
    osave.set_defaults(fn=cmd_operator_snapshot_save)
    omet = op.add_parser("metrics")
    omet.set_defaults(fn=cmd_operator_metrics)
    odefrag = op.add_parser(
        "defrag",
        help="live-migration status; --trigger runs a cycle now",
    )
    odefrag.add_argument("--trigger", action="store_true")
    odefrag.add_argument("--pause", action="store_true")
    odefrag.add_argument("--resume", action="store_true")
    odefrag.set_defaults(fn=cmd_operator_defrag)

    system = sub.add_parser("system", help="system commands").add_subparsers(
        dest="sub", required=True
    )
    sgc = system.add_parser("gc")
    sgc.set_defaults(fn=cmd_system_gc)

    scaling = sub.add_parser("scaling", help="scaling commands").add_subparsers(
        dest="sub", required=True
    )
    spol = scaling.add_parser("policies")
    spol.set_defaults(fn=cmd_scaling_policies)

    acl = sub.add_parser("acl", help="acl commands").add_subparsers(
        dest="acl_cmd", required=True
    )
    aboot = acl.add_parser("bootstrap")
    aboot.set_defaults(fn=cmd_acl_bootstrap)
    apol = acl.add_parser("policy").add_subparsers(
        dest="pol_cmd", required=True
    )
    apapply = apol.add_parser("apply")
    apapply.add_argument("name")
    apapply.add_argument("rules_file")
    apapply.set_defaults(fn=cmd_acl_policy_apply)
    aplist = apol.add_parser("list")
    aplist.set_defaults(fn=cmd_acl_policy_list)
    apdel = apol.add_parser("delete")
    apdel.add_argument("name")
    apdel.set_defaults(fn=cmd_acl_policy_delete)
    atok = acl.add_parser("token").add_subparsers(
        dest="tok_cmd", required=True
    )
    atcreate = atok.add_parser("create")
    atcreate.add_argument("--name", default="")
    atcreate.add_argument("--type", default="client")
    atcreate.add_argument("--policy", action="append")
    atcreate.set_defaults(fn=cmd_acl_token_create)
    atlist = atok.add_parser("list")
    atlist.set_defaults(fn=cmd_acl_token_list)
    atdel = atok.add_parser("delete")
    atdel.add_argument("accessor")
    atdel.set_defaults(fn=cmd_acl_token_delete)

    tr = sub.add_parser("trace", help="show recent eval traces")
    tr.add_argument("eval_id", nargs="?", default="")
    tr.add_argument("-json", action="store_true")
    tr.set_defaults(fn=cmd_trace)

    res = sub.add_parser(
        "resilience", help="circuit-breaker / degraded-mode status"
    ).add_subparsers(dest="res_cmd", required=True)
    rstat = res.add_parser("status")
    rstat.add_argument("-json", action="store_true")
    rstat.set_defaults(fn=cmd_resilience_status)

    slo = sub.add_parser(
        "slo", help="steady-state SLO report"
    ).add_subparsers(dest="slo_cmd", required=True)
    srep = slo.add_parser("report")
    srep.add_argument("-json", action="store_true")
    srep.add_argument(
        "--eval-p99-ms", type=float, default=None, dest="eval_p99_ms",
        help="override the eval-latency p99 target for the verdict",
    )
    srep.add_argument(
        "--placement-p99-ms", type=float, default=None,
        dest="placement_p99_ms",
        help="override the placement-latency p99 target for the verdict",
    )
    srep.set_defaults(fn=cmd_slo_report)

    calib = sub.add_parser(
        "calibrate", help="calibration plane: constant provenance, "
        "learned throughputs"
    ).add_subparsers(dest="calib_cmd", required=True)
    cstat = calib.add_parser("status")
    cstat.add_argument("-json", action="store_true")
    cstat.set_defaults(fn=cmd_calibrate_status)
    crep = calib.add_parser("report")
    crep.add_argument("-json", action="store_true")
    crep.set_defaults(fn=cmd_calibrate_report)

    ver = sub.add_parser("version", help="show version")
    ver.set_defaults(fn=cmd_version)

    nsp = sub.add_parser("namespace", help="namespace commands").add_subparsers(
        dest="ns_cmd", required=True
    )
    nlist = nsp.add_parser("list")
    nlist.set_defaults(fn=cmd_namespace)
    napply = nsp.add_parser("apply")
    napply.add_argument("name")
    napply.add_argument("-description", default="")
    napply.set_defaults(fn=cmd_namespace)
    ndel = nsp.add_parser("delete")
    ndel.add_argument("name")
    ndel.set_defaults(fn=cmd_namespace)
    nstat = nsp.add_parser("status")
    nstat.add_argument("name")
    nstat.set_defaults(fn=cmd_namespace)

    st = sub.add_parser("status", help="search across objects")
    st.add_argument("prefix", nargs="?", default="")
    st.set_defaults(fn=cmd_status)

    server = sub.add_parser("server", help="server commands").add_subparsers(
        dest="sub", required=True
    )
    members = server.add_parser("members")
    members.set_defaults(fn=cmd_server_members)

    chaos = sub.add_parser(
        "chaos", help="deterministic fault injection"
    ).add_subparsers(dest="chaos_cmd", required=True)
    crun = chaos.add_parser(
        "run", help="run a seeded in-process cluster under injected faults"
    )
    crun.add_argument("--seed", type=int, default=7)
    crun.add_argument("--steps", type=int, default=200)
    crun.add_argument(
        "--faults",
        default="",
        help="'+'-joined subset of raise+delay+duplicate+drop+kill+skew "
        "(default: all)",
    )
    crun.add_argument("--nodes", type=int, default=6)
    crun.add_argument(
        "--rate", type=float, default=0.04,
        help="fraction of each site's call horizon that faults",
    )
    crun.add_argument("--json", action="store_true",
                      help="emit the canonical (bit-reproducible) report")
    crun.add_argument("--batch-workers", type=int, default=1,
                      help="batching workers for the in-process cluster "
                      "(lane-partitioned commit path when > 1)")
    crun.add_argument("--verbose", action="store_true",
                      help="include timing-dependent diagnostics")
    crun.add_argument("--shrink", action="store_true",
                      help="on violation, shrink to a minimal failing "
                      "fault subset")
    crun.add_argument("--device", default="cuda",
                      help="where the cluster's kernels run: cuda "
                      "(default) or cpu")
    crun.set_defaults(fn=cmd_chaos_run)

    analyze = sub.add_parser(
        "analyze", help="static analysis over the hand-written kernel fleet"
    ).add_subparsers(dest="analyze_cmd", required=True)
    akern = analyze.add_parser(
        "kernels",
        help="exercise every kernel twice, run the JXL rules, and print "
        "the fingerprint table (ratchets vs kernellint/baseline.json)",
    )
    akern.add_argument("--json", action="store_true")
    akern.add_argument(
        "--fix-baseline", action="store_true",
        help="absorb current findings into the kernel baseline and exit 0",
    )
    akern.add_argument(
        "--diff", action="store_true",
        help="also run the invariance differ (explain, incremental and "
        "mesh on/off over the kernels launched)",
    )
    akern.add_argument(
        "--device", default="cuda",
        help="where the fleet runs: cuda (default) or cpu (the plain "
        "versions)",
    )
    akern.set_defaults(fn=cmd_analyze_kernels)

    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except BrokenPipeError:
        # output piped to a closed reader (e.g. `| head`) — not an error
        try:
            sys.stdout.close()
        except Exception:  # noqa: BLE001
            pass
        return 0


if __name__ == "__main__":
    sys.exit(main())
