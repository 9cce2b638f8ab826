"""ClusterServer — a consensus member serving the full server RPC surface.

Reference: nomad/server.go (endpoint registry :262-289, Raft wiring
:105-109) + nomad/rpc.go ``forward()`` (non-leader servers transparently
forward writes to the leader; requests tagged with a foreign region are
forwarded to a server of that region first — forwardRegion) +
nomad/leader.go monitorLeadership (establish/revoke leader services on
election).

Composition: Server (endpoints, broker, applier, watchers — leader-only
services gated by raft callbacks) + RPCServer (transport) + RaftNode
(replication). Clients and CLIs may talk to ANY server; reads answer
locally (eventually-consistent default, like stale=true) and writes chase
the leader.

Federation: each region is its own Raft cluster; ``region_peers`` maps
foreign region → server addresses (the reference discovers these via Serf
WAN gossip, nomad/serf.go:295 — this build takes a static peer map, the
same trade the core raft layer makes with its static peer set). A request
whose ``region`` differs from the local one is handed to a foreign server
verbatim (minus the tag) and the answer relayed — exactly the reference's
forwardRegion hop (nomad/rpc.go).

The JAX package's ``server/cluster.py`` with its imports rewritten. The
member's ``Server`` schedules on ``ServerConfig.device`` as any server
does: only the leader runs the schedulers, so only the leader's process
launches kernels; a follower applies the replicated log to its store.

One departure (ROADMAP C-R9): the leadership hooks and ``shutdown`` take
one lock, and a hook acts only on the state it finds under it. In the
JAX package the raft callbacks run on threads of their own, so a
``shutdown`` racing a fresh election could stop the leader services
while ``establish_leadership`` was still starting them, and a quick step
down could revoke before the establish it follows.
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, Optional

from ..raft import NotLeaderError, RaftNode
from ..raft.node import RaftConfig
from ..utils.metrics import count_swallowed
from ..rpc import RPCClient, RPCServer
from ..state.snapshot import restore_snapshot, save_snapshot
from .server import Server, ServerConfig

log = logging.getLogger(__name__)

# methods exposed over "Nomad." — name -> needs_leader
_ENDPOINTS = {
    # writes (forwarded to the leader)
    "register_job": True,
    "deregister_job": True,
    "dispatch_job": True,
    "register_node": True,
    "update_node_status": True,
    "update_node_drain": True,
    "update_allocs_from_client": True,
    "register_csi_volume": True,
    "deregister_csi_volume": True,
    "claim_csi_volume": True,
}


class ClusterServer:
    def __init__(
        self,
        node_id: str,
        peers: Dict[str, str],
        rpc_server: RPCServer,
        data_dir: Optional[str] = None,
        server_config: Optional[ServerConfig] = None,
        region_peers: Optional[Dict[str, list]] = None,
        gossip_seeds: Optional[list] = None,
        **raft_overrides,
    ):
        self.node_id = node_id
        self.rpc = rpc_server
        cfg = server_config or ServerConfig()
        self.region = cfg.region
        # foreign region → [server addr, ...]: static entries win, and
        # the gossip member table (serf.go:295 WAN analog) fills in the
        # rest when seeds are configured
        self.region_peers: Dict[str, list] = dict(region_peers or {})
        self.gossip = None
        if gossip_seeds is not None:
            from .gossip import Gossip

            self.gossip = Gossip(
                name=node_id,
                addr=rpc_server.address,
                region=self.region,
                rpc_server=rpc_server,
                seeds=list(gossip_seeds),
            )
        cfg.data_dir = None  # durability lives in the RaftNode's log
        self.server = Server(cfg)
        self.raft = RaftNode(
            RaftConfig(
                node_id=node_id, peers=dict(peers), data_dir=data_dir,
                **raft_overrides,
            ),
            self.server.fsm,
            snapshot_fn=lambda path: save_snapshot(self.server.store, path),
            restore_fn=lambda path: self.server._install_store(
                restore_snapshot(path)
            ),
            on_leader=self._on_leader,
            on_follower=self._on_follower,
        )
        self.server.attach_raft(self.raft)
        self._register_endpoints()
        self._forward_clients: dict[str, RPCClient] = {}
        self._fc_lock = threading.Lock()
        # autopilot dead-server cleanup (nomad/autopilot.go): a failed
        # gossip member that is also a raft peer is removed from the
        # voting set after this deadline, quorum permitting
        self.autopilot_interval = 2.0
        self.dead_server_cleanup_after = 10.0
        self._autopilot_stop: Optional[threading.Event] = None
        self._autopilot_thread: Optional[threading.Thread] = None
        # serializes the leadership hooks with each other and shutdown
        self._leadership = threading.Lock()
        self._closed = False

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        self.raft.start(self.rpc)
        if self.gossip is not None:
            self.gossip.start()
            self._autopilot_stop = threading.Event()
            self._autopilot_thread = threading.Thread(
                target=self._autopilot_loop,
                name=f"autopilot-{self.node_id}",
                daemon=True,
            )
            self._autopilot_thread.start()

    def shutdown(self) -> None:
        if getattr(self, "_autopilot_stop", None) is not None:
            self._autopilot_stop.set()
        if self.gossip is not None:
            self.gossip.stop()
        with self._leadership:
            self._closed = True
            if self.server._leader:
                self.server.revoke_leadership()
        self.raft.shutdown()

    # -- autopilot (nomad/autopilot.go dead-server cleanup) ----------------
    def autopilot_sweep(self) -> list:
        """One dead-server-cleanup pass: raft peers whose gossip member
        has been FAILED longer than the deadline are removed from the
        voting set — IF the survivors still hold quorum on their own
        (autopilot's guard: cleanup must never cause an outage that
        waiting would have avoided). Returns the peer ids removed."""
        import time as _time

        if self.gossip is None or not self.raft.is_leader():
            return []
        members = self.gossip.members_snapshot()
        peers = self.raft.peers()
        removed = []
        for pid in list(peers):
            if pid == self.node_id:
                continue
            m = members.get(pid)
            if m is None or m.status != "failed":
                continue
            # grace runs from the FAILED transition, not last_seen —
            # last_seen is routinely stale for healthy-but-unprobed
            # members, which would zero the grace for a transient blip
            failed_at = m.failed_since or m.last_seen
            if _time.time() - failed_at < self.dead_server_cleanup_after:
                continue
            # quorum guard: voters alive by gossip (self always counts).
            # The removal entry itself must commit under the CURRENT
            # config, so alive must reach the current-config majority —
            # not merely the post-removal one (on even-sized clusters the
            # post-removal bar is lower and the commit would just hang).
            alive = sum(
                1
                for q in peers
                if q != pid
                and (
                    q == self.node_id
                    or (members.get(q) is not None
                        and members[q].status == "alive")
                )
            )
            post_voters = len(peers) - 1
            need = max(len(peers) // 2 + 1, post_voters // 2 + 1)
            if alive < need:
                log.warning(
                    "autopilot: NOT removing failed server %s — %d voters "
                    "alive, need %d to commit and survive", pid, alive, need,
                )
                continue
            try:
                self.raft.remove_peer(pid)
                removed.append(pid)
                peers = self.raft.peers()
                log.info("autopilot: removed dead server %s", pid)
            except Exception as e:
                log.exception("autopilot: remove_peer %s failed", pid)
                count_swallowed("cluster", e)
        return removed

    def _autopilot_loop(self) -> None:
        while not self._autopilot_stop.wait(self.autopilot_interval):
            try:
                self.autopilot_sweep()
            except Exception as e:
                log.exception("autopilot sweep failed")
                count_swallowed("cluster", e)

    # -- leadership hooks (leader.go monitorLeadership) --------------------
    def _on_leader(self) -> None:
        try:
            # barrier: ensure our FSM has caught up with every commit of
            # prior terms before enabling schedulers (leader.go:230 Barrier)
            self.raft.barrier(timeout=10.0)
            with self._leadership:
                # a step down or a shutdown may have come first
                if self._closed or not self.raft.is_leader():
                    return
                self.server.establish_leadership()
        except Exception:
            log.exception("establish_leadership failed")

    def _on_follower(self) -> None:
        try:
            with self._leadership:
                if self.server._leader:
                    self.server.revoke_leadership()
        except Exception:
            log.exception("revoke_leadership failed")

    # -- RPC surface -------------------------------------------------------
    def _register_endpoints(self) -> None:
        for name, needs_leader in _ENDPOINTS.items():
            self.rpc.register(f"Nomad.{name}", self._make_handler(name))
        self.rpc.register("Nomad.heartbeat", self._handle_heartbeat)
        self.rpc.register("Nomad.pull_allocs", self._handle_pull_allocs)
        self.rpc.register("Nomad.leader", lambda a: {
            "leader": self.raft.leader_id(),
            "leader_addr": self.raft.leader_addr(),
        })
        self.rpc.register("Nomad.stats", lambda a: self.raft.stats())
        self.rpc.register(
            "Nomad.csi_volume_info", self._handle_csi_volume_info
        )

    def _handle_csi_volume_info(self, args):
        from .server import InProcessClientRPC

        return {
            "info": InProcessClientRPC(self.server).csi_volume_info(
                (args or {}).get("volume_id", "")
            )
        }

    def _make_handler(self, name: str):
        fn = getattr(self.server, name)

        def handler(args):
            kwargs = dict(args or {})
            hops = kwargs.pop("_hops", 0)
            # cross-region hop first (nomad/rpc.go forwardRegion): a
            # request tagged for a foreign region goes there verbatim;
            # the receiving region then does its own leader chase
            region = kwargs.pop("region", None)
            if region is None and name == "register_job":
                # Job.Register routes by the job's own region stanza
                # (job_endpoint.go forwards to job.Region)
                job = kwargs.get("job")
                jr = getattr(job, "region", "") if job is not None else ""
                # "global" is the canonical default region stanza
                # (structs.Job Canonicalize): it means "wherever
                # submitted", never a forwarding target
                if jr and jr != "global" and jr != self.region:
                    region = jr
            if region and region != self.region:
                addrs = self.region_peers.get(region)
                if not addrs and self.gossip is not None:
                    addrs = self.gossip.region_peers().get(region)
                if not addrs:
                    raise ValueError(f"no path to region {region!r}")
                if hops >= 3:
                    raise RuntimeError("region forward loop")
                kwargs["_hops"] = hops + 1
                last_err: Exception | None = None
                for addr in addrs:  # failover across the region's servers
                    try:
                        return self._forward(addr, f"Nomad.{name}", kwargs)
                    except (ConnectionError, TimeoutError, OSError) as e:
                        last_err = e
                raise ConnectionError(
                    f"region {region!r} unreachable: {last_err}"
                )
            try:
                return fn(**kwargs)
            except NotLeaderError as e:
                if hops >= 3:
                    raise
                addr = e.leader_addr or self.raft.leader_addr()
                if not addr or addr == self.rpc.address:
                    raise
                kwargs["_hops"] = hops + 1
                return self._forward(addr, f"Nomad.{name}", kwargs)

        return handler

    def _forward(self, addr: str, method: str, args: dict):
        with self._fc_lock:
            c = self._forward_clients.get(addr)
            if c is None:
                c = RPCClient(addr)
                self._forward_clients[addr] = c
        return c.call(method, args)

    # client-plane handlers: alloc pulls are served by any server against
    # local state (node_endpoint.go allows stale reads for GetClientAllocs);
    # heartbeats must reach the LEADER's TTL timers — dead-node detection
    # lives there (nomad/heartbeat.go is leader-only state) — so a follower
    # forwards them like any write
    def _handle_heartbeat(self, args):
        hops = args.pop("_hops", 0) if isinstance(args, dict) else 0
        node_id = args["node_id"]
        if not self.server._leader:
            addr = self.raft.leader_addr()
            if hops < 3 and addr and addr != self.rpc.address:
                return self._forward(
                    addr, "Nomad.heartbeat",
                    {"node_id": node_id, "_hops": hops + 1},
                )
            # no reachable leader: grant a local grace TTL so the client
            # keeps retrying rather than declaring the cluster gone
            return self.server.config.heartbeat_ttl
        node = self.server.store.node_by_id(node_id)
        if node is not None and node.status == "down":
            # node recovered after missed TTLs (heartbeat.go resurrection)
            self.server.update_node_status(node_id, "ready")
        return self.server.heartbeater.heartbeat(node_id)

    def _handle_pull_allocs(self, args):
        allocs, index = self.server.pull_allocs(
            args["node_id"], args.get("min_index", 0),
            timeout=args.get("timeout", 1.0),
        )
        return {"allocs": allocs, "index": index}


class RemoteClientRPC:
    """The client agent's transport to a server cluster: mirrors
    InProcessClientRPC over TCP with server-list failover (client/rpc.go
    RemoteServers + rebalance-on-failure)."""

    def __init__(self, servers: list[str], timeout: float = 10.0):
        self.servers = list(servers)
        self.timeout = timeout
        self._clients: dict[str, RPCClient] = {}
        self._cur = 0

    def _call(self, method: str, args: dict):
        last_err: Optional[Exception] = None
        for attempt in range(len(self.servers)):
            addr = self.servers[self._cur % len(self.servers)]
            c = self._clients.get(addr)
            if c is None:
                c = RPCClient(addr, timeout=self.timeout)
                self._clients[addr] = c
            try:
                return c.call(method, args)
            except (ConnectionError, TimeoutError, OSError) as e:
                last_err = e
                self._cur += 1  # rotate to the next server
        raise ConnectionError(
            f"all servers unreachable for {method}: {last_err}"
        )

    def register_node(self, node) -> None:
        self._call("Nomad.register_node", {"node": node})
        self._call("Nomad.heartbeat", {"node_id": node.id})

    def heartbeat(self, node_id: str) -> float:
        return self._call("Nomad.heartbeat", {"node_id": node_id})

    def pull_allocs(self, node_id: str, min_index: int, timeout: float):
        resp = self._call(
            "Nomad.pull_allocs",
            {"node_id": node_id, "min_index": min_index, "timeout": timeout},
        )
        return resp["allocs"], resp["index"]

    def update_allocs(self, updates) -> None:
        self._call(
            "Nomad.update_allocs_from_client", {"updates": list(updates)}
        )

    def csi_volume_info(self, volume_id: str):
        resp = self._call(
            "Nomad.csi_volume_info", {"volume_id": volume_id}
        )
        info = (resp or {}).get("info")
        return tuple(info) if info else None

    def close(self) -> None:
        for c in self._clients.values():
            c.close()
