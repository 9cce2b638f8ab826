"""Agent HCL configuration — file + defaults merge.

Reference: command/agent/config.go (the `Config` struct: top-level
region/datacenter/name/data_dir/bind_addr, `server`/`client`/`telemetry`
blocks, duration strings) and config_parse.go. CLI flags override file
values, files merge left-to-right over the defaults — the same
DefaultConfig().Merge(file).Merge(flags) pipeline, reduced to the knobs
this build actually consumes."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from .jobspec.parse import parse_duration
from .utils import hcl


@dataclass
class AgentServerConfig:
    enabled: bool = False
    num_schedulers: Optional[int] = None  # nomad/config.go:468 default CPU
    heartbeat_ttl_s: float = 10.0
    region: str = "global"


@dataclass
class AgentClientConfig:
    enabled: bool = False
    servers: list[str] = field(default_factory=list)
    host_volumes: dict[str, str] = field(default_factory=dict)
    driver_mode: str = "inprocess"  # or "plugin" (out-of-process drivers)
    gc_max_allocs: Optional[int] = None


@dataclass
class AgentTelemetryConfig:
    collection_interval_s: float = 1.0
    publish_allocation_metrics: bool = False


@dataclass
class AgentConfig:
    region: str = "global"
    datacenter: str = "dc1"
    name: str = ""
    data_dir: str = ""
    bind_addr: str = "127.0.0.1"
    http_port: int = 4646
    server: AgentServerConfig = field(default_factory=AgentServerConfig)
    client: AgentClientConfig = field(default_factory=AgentClientConfig)
    telemetry: AgentTelemetryConfig = field(
        default_factory=AgentTelemetryConfig
    )


def _attrs(body: hcl.Body) -> dict:
    ctx = hcl.EvalContext()
    return {name: a.expr(ctx) for name, a in body.attrs.items()}


def _blocks(body: hcl.Body, btype: str):
    return body.blocks_of(btype)


def parse_agent_config(src: str, base: Optional[AgentConfig] = None) -> AgentConfig:
    """Parse one HCL config source over ``base`` (merge semantics:
    present attributes override, absent ones inherit —
    command/agent/config.go Merge)."""
    cfg = base or AgentConfig()
    body = hcl.parse(src)
    top = _attrs(body)
    for key in ("region", "datacenter", "name", "data_dir", "bind_addr"):
        if key in top:
            setattr(cfg, key, str(top[key]))
    if "ports" in top and isinstance(top["ports"], dict):
        cfg.http_port = int(top["ports"].get("http", cfg.http_port))
    for b in _blocks(body, "ports"):
        a = _attrs(b.body)
        if "http" in a:
            cfg.http_port = int(a["http"])

    for b in _blocks(body, "server"):
        a = _attrs(b.body)
        if "enabled" in a:
            cfg.server.enabled = bool(a["enabled"])
        if "num_schedulers" in a:
            cfg.server.num_schedulers = int(a["num_schedulers"])
        if "heartbeat_grace" in a:
            cfg.server.heartbeat_ttl_s = parse_duration(a["heartbeat_grace"])
        cfg.server.region = cfg.region

    for b in _blocks(body, "client"):
        a = _attrs(b.body)
        if "enabled" in a:
            cfg.client.enabled = bool(a["enabled"])
        if "servers" in a:
            cfg.client.servers = [str(s) for s in a["servers"]]
        if "driver_mode" in a:
            cfg.client.driver_mode = str(a["driver_mode"])
        if "gc_max_allocs" in a:
            cfg.client.gc_max_allocs = int(a["gc_max_allocs"])
        for hv in _blocks(b.body, "host_volume"):
            ha = _attrs(hv.body)
            if hv.labels and "path" in ha:
                cfg.client.host_volumes[hv.labels[0]] = str(ha["path"])

    for b in _blocks(body, "telemetry"):
        a = _attrs(b.body)
        if "collection_interval" in a:
            cfg.telemetry.collection_interval_s = parse_duration(
                a["collection_interval"]
            )
        if "publish_allocation_metrics" in a:
            cfg.telemetry.publish_allocation_metrics = bool(
                a["publish_allocation_metrics"]
            )
    return cfg


def load_agent_config(paths: list[str]) -> AgentConfig:
    """Defaults ← file₁ ← file₂ ... (config.go LoadConfig merge order)."""
    cfg = AgentConfig()
    for path in paths:
        with open(path) as f:
            cfg = parse_agent_config(f.read(), base=cfg)
    return cfg
