"""HCL jobspec parser.

Reference grammar: jobspec/parse.go + jobspec2/parse_job.go — the
``job`` block with nested group/task/resources/constraint/affinity/
spread/update/periodic/parameterized/network/restart/reschedule/
migrate/ephemeral_disk/lifecycle/artifact/template/meta stanzas —
plus jobspec2's two-phase evaluation: ``variable``/``locals`` blocks
are collected first, then the job body is evaluated with ``var.*`` /
``local.*`` in scope (jobspec2/parse.go:19, jobspec2/types.variables.go).

Durations accept Go syntax ("30s", "5m", "1h30m", "500ms").
"""

from __future__ import annotations

import re
from typing import Any, Optional

from ..structs.job import (
    Affinity,
    Constraint,
    CONSTRAINT_ATTRIBUTE_IS_NOT_SET,
    CONSTRAINT_ATTRIBUTE_IS_SET,
    CONSTRAINT_DISTINCT_HOSTS,
    CONSTRAINT_DISTINCT_PROPERTY,
    CONSTRAINT_REGEX,
    CONSTRAINT_SEMVER,
    CONSTRAINT_SET_CONTAINS,
    CONSTRAINT_VERSION,
    EphemeralDisk,
    Job,
    JOB_DEFAULT_PRIORITY,
    MigrateStrategy,
    ParameterizedJobConfig,
    PeriodicConfig,
    ReschedulePolicy,
    RestartPolicy,
    Spread,
    SpreadTarget,
    Task,
    TaskGroup,
    UpdateStrategy,
)
from ..structs.resources import NetworkResource, RequestedDevice, Resources
from ..utils import hcl


class JobspecError(Exception):
    pass


class _RuntimeRef:
    """Self-quoting placeholder for scheduler-time interpolation targets.

    ``${attr.kernel.name}`` / ``${node.datacenter}`` / ``${meta.rack}`` are
    NOT jobspec variables — the scheduler resolves them per node
    (scheduler/feasible.go:748-781 resolveTarget). Evaluating one here
    reproduces the literal ``${...}`` text so it survives into the
    Constraint/Affinity/Spread structs unchanged.
    """

    def __init__(self, path: str):
        self._path = path

    def __getattr__(self, key: str) -> "_RuntimeRef":
        if key.startswith("_"):
            raise AttributeError(key)
        return _RuntimeRef(f"{self._path}.{key}")

    def __getitem__(self, key) -> "_RuntimeRef":
        return _RuntimeRef(f"{self._path}.{key}")

    def __str__(self) -> str:
        return "${" + self._path + "}"


# env.* and NOMAD_* also interpolate at task runtime (client/taskenv)
RUNTIME_VARS = ("attr", "node", "meta", "device", "env")


def _jobspec_ctx(variables: dict, local_values: dict) -> hcl.EvalContext:
    scope: dict[str, Any] = {name: _RuntimeRef(name) for name in RUNTIME_VARS}
    scope["var"] = variables
    scope["local"] = local_values
    return hcl.EvalContext(scope)


_DURATION_RE = re.compile(r"(\d+(?:\.\d+)?)(ns|us|µs|ms|s|m|h|d)")
_DURATION_UNITS = {
    "ns": 1e-9,
    "us": 1e-6,
    "µs": 1e-6,
    "ms": 1e-3,
    "s": 1.0,
    "m": 60.0,
    "h": 3600.0,
    "d": 86400.0,
}


def parse_duration(v: Any) -> float:
    """Go-style duration → seconds. Numbers pass through as seconds."""
    if isinstance(v, (int, float)):
        return float(v)
    s = str(v).strip()
    if not s:
        return 0.0
    pos = 0
    total = 0.0
    for m in _DURATION_RE.finditer(s):
        if m.start() != pos:
            raise JobspecError(f"invalid duration {v!r}")
        total += float(m.group(1)) * _DURATION_UNITS[m.group(2)]
        pos = m.end()
    if pos != len(s):
        raise JobspecError(f"invalid duration {v!r}")
    return total


def _attrs(body: hcl.Body, ctx: hcl.EvalContext) -> dict[str, Any]:
    return {name: a.expr(ctx) for name, a in body.attrs.items()}


def _meta(body: hcl.Body, ctx: hcl.EvalContext) -> dict[str, str]:
    """meta {} block or meta = {} attribute."""
    out: dict[str, str] = {}
    for b in body.blocks_of("meta"):
        out.update({k: str(v) for k, v in _attrs(b.body, ctx).items()})
    if "meta" in body.attrs:
        out.update(
            {k: str(v) for k, v in (body.attrs["meta"].expr(ctx) or {}).items()}
        )
    return out


# -- constraint / affinity / spread -----------------------------------------

_CONSTRAINT_SHORTHANDS = {
    # attr name in the block → operand it implies (jobspec/parse.go
    # parseConstraints: regexp/version/semver/distinct_hosts/...)
    "regexp": CONSTRAINT_REGEX,
    "version": CONSTRAINT_VERSION,
    "semver": CONSTRAINT_SEMVER,
    "set_contains": CONSTRAINT_SET_CONTAINS,
    "set_contains_any": "set_contains_any",
    "set_contains_all": "set_contains_all",
}


def _parse_constraint(b: hcl.Body, ctx: hcl.EvalContext) -> Constraint:
    a = _attrs(b, ctx)
    c = Constraint(
        l_target=str(a.get("attribute", "")),
        operand=str(a.get("operator", "=")),
        r_target=str(a.get("value", "")),
    )
    for short, operand in _CONSTRAINT_SHORTHANDS.items():
        if short in a:
            c.operand = operand
            c.r_target = str(a[short])
    if a.get("distinct_hosts"):
        c.operand = CONSTRAINT_DISTINCT_HOSTS
        c.l_target = c.r_target = ""
    if "distinct_property" in a:
        c.operand = CONSTRAINT_DISTINCT_PROPERTY
        c.l_target = str(a["distinct_property"])
        c.r_target = str(a.get("value", "")) if "value" in a else ""
    if c.operand in (CONSTRAINT_ATTRIBUTE_IS_SET, CONSTRAINT_ATTRIBUTE_IS_NOT_SET):
        c.r_target = ""
    return c


def _parse_affinity(b: hcl.Body, ctx: hcl.EvalContext) -> Affinity:
    a = _attrs(b, ctx)
    aff = Affinity(
        l_target=str(a.get("attribute", "")),
        operand=str(a.get("operator", "=")),
        r_target=str(a.get("value", "")),
        weight=int(a.get("weight", 50)),
    )
    for short, operand in _CONSTRAINT_SHORTHANDS.items():
        if short in a:
            aff.operand = operand
            aff.r_target = str(a[short])
    return aff


def _parse_spread(b: hcl.Body, ctx: hcl.EvalContext) -> Spread:
    a = _attrs(b, ctx)
    sp = Spread(
        attribute=str(a.get("attribute", "")), weight=int(a.get("weight", 50))
    )
    for tb in b.blocks_of("target"):
        ta = _attrs(tb.body, ctx)
        label = tb.labels[0] if tb.labels else str(ta.get("value", ""))
        sp.targets.append(
            SpreadTarget(value=label, percent=int(ta.get("percent", 0)))
        )
    return sp


def _collect_cas(body: hcl.Body, ctx, constraints, affinities, spreads=None):
    for cb in body.blocks_of("constraint"):
        constraints.append(_parse_constraint(cb.body, ctx))
    for ab in body.blocks_of("affinity"):
        affinities.append(_parse_affinity(ab.body, ctx))
    if spreads is not None:
        for sb in body.blocks_of("spread"):
            spreads.append(_parse_spread(sb.body, ctx))


# -- resources ---------------------------------------------------------------


def _parse_network(b: hcl.Body, ctx: hcl.EvalContext) -> NetworkResource:
    a = _attrs(b, ctx)
    net = NetworkResource(
        mode=str(a.get("mode", "host")), mbits=int(a.get("mbits", 0))
    )
    for pb in b.blocks_of("port"):
        label = pb.labels[0] if pb.labels else ""
        pa = _attrs(pb.body, ctx)
        if "static" in pa:
            net.reserved_ports.append(int(pa["static"]))
        else:
            net.dynamic_ports.append(label)
    return net


def _parse_resources(b: hcl.Body, ctx: hcl.EvalContext) -> Resources:
    a = _attrs(b, ctx)
    res = Resources(
        cpu=int(a.get("cpu", 100)),
        memory_mb=int(a.get("memory", a.get("memory_mb", 300))),
        disk_mb=int(a.get("disk", a.get("disk_mb", 0))),
    )
    for nb in b.blocks_of("network"):
        res.networks.append(_parse_network(nb.body, ctx))
    for db in b.blocks_of("device"):
        name = db.labels[0] if db.labels else ""
        da = _attrs(db.body, ctx)
        dev = RequestedDevice(name=name, count=int(da.get("count", 1)))
        _collect_cas(db.body, ctx, dev.constraints, dev.affinities)
        res.devices.append(dev)
    return res


# -- task ---------------------------------------------------------------------


def _parse_task(block: hcl.Block, ctx: hcl.EvalContext) -> Task:
    if not block.labels:
        raise JobspecError("task block requires a name label")
    b = block.body
    a = _attrs(b, ctx)
    t = Task(
        name=block.labels[0],
        driver=str(a.get("driver", "exec")),
        user=str(a.get("user", "")),
        leader=bool(a.get("leader", False)),
        kind=str(a.get("kind", "")),
    )
    if "kill_timeout" in a:
        t.kill_timeout_s = parse_duration(a["kill_timeout"])
    cfg = b.first("config")
    if cfg is not None:
        t.config = _attrs(cfg.body, ctx)
    env = b.first("env")
    if env is not None:
        t.env = {k: str(v) for k, v in _attrs(env.body, ctx).items()}
    res = b.first("resources")
    if res is not None:
        t.resources = _parse_resources(res.body, ctx)
    lc = b.first("lifecycle")
    if lc is not None:
        la = _attrs(lc.body, ctx)
        t.lifecycle_hook = str(la.get("hook", ""))
        t.lifecycle_sidecar = bool(la.get("sidecar", False))
    logs = b.first("logs")
    if logs is not None:
        from ..structs.job import LogConfig

        lga = _attrs(logs.body, ctx)
        t.log_config = LogConfig(
            max_files=int(lga.get("max_files", 10)),
            max_file_size_mb=int(lga.get("max_file_size", 10)),
        )
    for vm in b.blocks_of("volume_mount"):
        from ..structs.volumes import VolumeMount

        va = _attrs(vm.body, ctx)
        t.volume_mounts.append(
            VolumeMount(
                volume=str(va.get("volume", "")),
                destination=str(va.get("destination", "")),
                read_only=bool(va.get("read_only", False)),
            )
        )
    for ab in b.blocks_of("artifact"):
        t.artifacts.append(_attrs(ab.body, ctx))
    for tb in b.blocks_of("template"):
        t.templates.append(_attrs(tb.body, ctx))
    t.meta = _meta(b, ctx)
    _collect_cas(b, ctx, t.constraints, t.affinities)
    return t


# -- group ---------------------------------------------------------------------


def _parse_restart(b: hcl.Body, ctx) -> RestartPolicy:
    a = _attrs(b, ctx)
    rp = RestartPolicy()
    if "attempts" in a:
        rp.attempts = int(a["attempts"])
    if "interval" in a:
        rp.interval_s = parse_duration(a["interval"])
    if "delay" in a:
        rp.delay_s = parse_duration(a["delay"])
    if "mode" in a:
        rp.mode = str(a["mode"])
    return rp


def _parse_reschedule(b: hcl.Body, ctx) -> ReschedulePolicy:
    a = _attrs(b, ctx)
    rp = ReschedulePolicy()
    if "attempts" in a:
        rp.attempts = int(a["attempts"])
        rp.unlimited = False
    if "interval" in a:
        rp.interval_s = parse_duration(a["interval"])
    if "delay" in a:
        rp.delay_s = parse_duration(a["delay"])
    if "delay_function" in a:
        rp.delay_function = str(a["delay_function"])
    if "max_delay" in a:
        rp.max_delay_s = parse_duration(a["max_delay"])
    if "unlimited" in a:
        rp.unlimited = bool(a["unlimited"])
    return rp


def _parse_update(b: hcl.Body, ctx) -> UpdateStrategy:
    a = _attrs(b, ctx)
    u = UpdateStrategy()
    if "max_parallel" in a:
        u.max_parallel = int(a["max_parallel"])
    if "health_check" in a:
        u.health_check = str(a["health_check"])
    if "min_healthy_time" in a:
        u.min_healthy_time_s = parse_duration(a["min_healthy_time"])
    if "healthy_deadline" in a:
        u.healthy_deadline_s = parse_duration(a["healthy_deadline"])
    if "progress_deadline" in a:
        u.progress_deadline_s = parse_duration(a["progress_deadline"])
    if "auto_revert" in a:
        u.auto_revert = bool(a["auto_revert"])
    if "auto_promote" in a:
        u.auto_promote = bool(a["auto_promote"])
    if "canary" in a:
        u.canary = int(a["canary"])
    if "stagger" in a:
        u.stagger_s = parse_duration(a["stagger"])
    return u


def _parse_migrate(b: hcl.Body, ctx) -> MigrateStrategy:
    a = _attrs(b, ctx)
    m = MigrateStrategy()
    if "max_parallel" in a:
        m.max_parallel = int(a["max_parallel"])
    if "health_check" in a:
        m.health_check = str(a["health_check"])
    if "min_healthy_time" in a:
        m.min_healthy_time_s = parse_duration(a["min_healthy_time"])
    if "healthy_deadline" in a:
        m.healthy_deadline_s = parse_duration(a["healthy_deadline"])
    return m


def _parse_group(block: hcl.Block, ctx: hcl.EvalContext, job: Job) -> TaskGroup:
    if not block.labels:
        raise JobspecError("group block requires a name label")
    b = block.body
    a = _attrs(b, ctx)
    tg = TaskGroup(name=block.labels[0], count=int(a.get("count", 1)))
    if "stop_after_client_disconnect" in a:
        tg.stop_after_client_disconnect_s = parse_duration(
            a["stop_after_client_disconnect"]
        )
    rb = b.first("restart")
    if rb is not None:
        tg.restart_policy = _parse_restart(rb.body, ctx)
    rs = b.first("reschedule")
    if rs is not None:
        tg.reschedule_policy = _parse_reschedule(rs.body, ctx)
    ub = b.first("update")
    if ub is not None:
        tg.update = _parse_update(ub.body, ctx)
    mb = b.first("migrate")
    if mb is not None:
        tg.migrate = _parse_migrate(mb.body, ctx)
    eb = b.first("ephemeral_disk")
    if eb is not None:
        ea = _attrs(eb.body, ctx)
        tg.ephemeral_disk = EphemeralDisk(
            size_mb=int(ea.get("size", 300)),
            sticky=bool(ea.get("sticky", False)),
            migrate=bool(ea.get("migrate", False)),
        )
    for vb in b.blocks_of("volume"):
        from ..structs.volumes import VolumeRequest

        if not vb.labels:
            raise JobspecError("volume block requires a name label")
        va = _attrs(vb.body, ctx)
        tg.volumes[vb.labels[0]] = VolumeRequest(
            name=vb.labels[0],
            type=str(va.get("type", "host")),
            source=str(va.get("source", "")),
            read_only=bool(va.get("read_only", False)),
            per_alloc=bool(va.get("per_alloc", False)),
            access_mode=str(va.get("access_mode", "")),
            attachment_mode=str(va.get("attachment_mode", "")),
        )
    for nb in b.blocks_of("network"):
        tg.networks.append(_parse_network(nb.body, ctx))
    sb = b.first("scaling")
    if sb is not None:
        from ..structs.job import ScalingPolicy

        sa = _attrs(sb.body, ctx)
        pol = {}
        pb = sb.body.first("policy")
        if pb is not None:
            pol = _attrs(pb.body, ctx)
        tg.scaling = ScalingPolicy(
            min=int(sa.get("min", 0)),
            max=int(sa.get("max", 0)),
            enabled=bool(sa.get("enabled", True)),
            policy=pol,
        )
    _collect_cas(b, ctx, tg.constraints, tg.affinities, tg.spreads)
    tg.meta = _meta(b, ctx)
    for tb in b.blocks_of("task"):
        tg.tasks.append(_parse_task(tb, ctx))
    if not tg.tasks:
        raise JobspecError(f"group {tg.name!r} has no tasks")
    return tg


# -- job ------------------------------------------------------------------------


def _parse_throughputs(b: hcl.Body, ctx: hcl.EvalContext, job_id: str) -> dict:
    """``throughput {}`` block or ``throughput = {...}`` attribute:
    device_class → relative rate coefficient. Rejected with a structured
    JobspecError (one line per offending coefficient) instead of letting
    NaN/negative/garbage values propagate into the scoring kernels."""
    from ..structs.job import validate_throughputs

    raw: dict[str, Any] = {}
    for tb in b.blocks_of("throughput"):
        raw.update(_attrs(tb.body, ctx))
    if "throughput" in b.attrs:
        val = b.attrs["throughput"].expr(ctx)
        if not isinstance(val, dict):
            raise JobspecError(
                f"job {job_id!r}: throughput must be a mapping of "
                f"device_class -> coefficient, got {type(val).__name__}"
            )
        raw.update(val)
    if not raw:
        return {}
    problems = validate_throughputs(raw)
    if problems:
        raise JobspecError(
            f"job {job_id!r}: invalid throughput stanza:\n  "
            + "\n  ".join(problems)
        )
    return {k: float(v) for k, v in raw.items()}


def _parse_gang(b: hcl.Body, ctx: hcl.EvalContext, job_id: str) -> dict:
    """``gang {}`` block: all-or-nothing member groups plus optional
    colocate/spread topology terms. Group-name references are checked
    against the job's real groups later (validate_job), after groups
    have parsed; the structural checks reject here with exact
    messages."""
    from ..structs.job import validate_gang

    gb = b.first("gang")
    if gb is None:
        return {}
    ga = _attrs(gb.body, ctx)
    gang: dict[str, Any] = {}
    if "groups" in ga:
        gang["groups"] = list(ga["groups"]) if isinstance(
            ga["groups"], (list, tuple)
        ) else ga["groups"]
    for stanza in ("colocate", "spread"):
        tb = gb.body.first(stanza)
        if tb is not None:
            gang[stanza] = _attrs(tb.body, ctx)
        elif stanza in ga:
            gang[stanza] = ga[stanza]
    problems = validate_gang(gang)
    if problems:
        raise JobspecError(
            f"job {job_id!r}: invalid gang stanza:\n  " + "\n  ".join(problems)
        )
    return gang


def parse_job(block: hcl.Block, ctx: hcl.EvalContext) -> Job:
    if not block.labels:
        raise JobspecError("job block requires an id label")
    b = block.body
    a = _attrs(b, ctx)
    job = Job(
        id=block.labels[0],
        name=str(a.get("name", block.labels[0])),
        namespace=str(a.get("namespace", "default")),
        type=str(a.get("type", "service")),
        priority=int(a.get("priority", JOB_DEFAULT_PRIORITY)),
        region=str(a.get("region", "global")),
        all_at_once=bool(a.get("all_at_once", False)),
    )
    if "datacenters" in a:
        job.datacenters = [str(d) for d in a["datacenters"]]
    pb = b.first("periodic")
    if pb is not None:
        pa = _attrs(pb.body, ctx)
        job.periodic = PeriodicConfig(
            enabled=bool(pa.get("enabled", True)),
            spec=str(pa.get("cron", pa.get("spec", ""))),
            prohibit_overlap=bool(pa.get("prohibit_overlap", False)),
            time_zone=str(pa.get("time_zone", "UTC")),
        )
    qb = b.first("parameterized")
    if qb is not None:
        qa = _attrs(qb.body, ctx)
        job.parameterized = ParameterizedJobConfig(
            payload=str(qa.get("payload", "optional")),
            meta_required=[str(x) for x in qa.get("meta_required", [])],
            meta_optional=[str(x) for x in qa.get("meta_optional", [])],
        )
    _collect_cas(b, ctx, job.constraints, job.affinities, job.spreads)
    job.meta = _meta(b, ctx)
    job.throughputs = _parse_throughputs(b, ctx, job.id)
    job.gang = _parse_gang(b, ctx, job.id)
    # job-level update{} is the default for all groups (jobspec semantics)
    job_update: Optional[UpdateStrategy] = None
    ub = b.first("update")
    if ub is not None:
        job_update = _parse_update(ub.body, ctx)
    for gb in b.blocks_of("group"):
        tg = _parse_group(gb, ctx, job)
        if tg.update is None and job_update is not None:
            import copy

            tg.update = copy.copy(job_update)
        job.task_groups.append(tg)
    if not job.task_groups:
        raise JobspecError(f"job {job.id!r} has no groups")
    if job.type not in ("service", "batch", "system", "sysbatch"):
        raise JobspecError(f"invalid job type {job.type!r}")
    return job


def parse_job_file(src: str, variables: Optional[dict[str, Any]] = None) -> Job:
    """Two-phase parse (jobspec2): collect variable/locals blocks, then
    evaluate the job block with var/local in scope. ``variables`` overrides
    variable defaults (the -var CLI flag)."""
    try:
        body = hcl.parse(src)
    except hcl.HCLError as e:
        raise JobspecError(str(e)) from e

    base_ctx = hcl.EvalContext()
    var_values: dict[str, Any] = {}
    for vb in body.blocks_of("variable"):
        if not vb.labels:
            raise JobspecError("variable block requires a name label")
        name = vb.labels[0]
        if variables and name in variables:
            var_values[name] = variables[name]
        elif "default" in vb.body.attrs:
            var_values[name] = vb.body.attrs["default"].expr(base_ctx)
        else:
            raise JobspecError(f"variable {name!r} has no value")
    if variables:
        unknown = set(variables) - {vb.labels[0] for vb in body.blocks_of("variable")}
        if unknown:
            raise JobspecError(f"undeclared variables: {sorted(unknown)}")

    ctx = _jobspec_ctx(var_values, {})
    local_values: dict[str, Any] = {}
    for lb in body.blocks_of("locals") + body.blocks_of("local"):
        for name, attr in lb.body.attrs.items():
            local_values[name] = attr.expr(ctx)
    ctx = _jobspec_ctx(var_values, local_values)

    jb = body.first("job")
    if jb is None:
        raise JobspecError("no job block found")
    try:
        return parse_job(jb, ctx)
    except hcl.HCLError as e:
        raise JobspecError(str(e)) from e
