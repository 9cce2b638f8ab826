"""Gossip membership — the Serf/memberlist analog.

Reference: nomad/serf.go:295 (server membership + WAN federation via
hashicorp/serf) and docs/internals/gossip.mdx. Nomad uses gossip for
three things this module reproduces over the existing framed RPC
transport instead of a dedicated UDP protocol:

- **membership**: every server keeps a table of all known servers and
  learns about new ones transitively (push-pull anti-entropy: each
  interval, sync the full table with one random live peer);
- **failure detection**: a peer that fails consecutive syncs is marked
  suspect, then failed; any fresher incarnation revives it, and a server
  hearing itself declared failed refutes by bumping its own incarnation
  (the SWIM refutation rule memberlist implements);
- **federation discovery**: members carry their region, so the set of
  reachable foreign-region servers (ClusterServer.region_peers) is
  derived from the table instead of static configuration — the WAN-pool
  role Serf plays in the reference.

Deliberately NOT consensus: the table is eventually consistent and
advisory, exactly like Serf beside Raft in the reference.

The JAX package's ``server/gossip.py`` with its imports rewritten; the
sync target is drawn from ``rng``, a ``random.Random`` seeded from the
member's name unless the caller passes one, not from the module-level
generator.
"""

from __future__ import annotations

import logging
import random
import threading
import time
from dataclasses import asdict, dataclass, field

from ..rpc import RPCClient

log = logging.getLogger(__name__)

STATUS_ALIVE = "alive"
STATUS_SUSPECT = "suspect"
STATUS_FAILED = "failed"

SUSPECT_AFTER = 2  # consecutive failed syncs
FAILED_AFTER = 4


@dataclass
class Member:
    name: str
    addr: str
    region: str
    status: str = STATUS_ALIVE
    incarnation: int = 0
    last_seen: float = field(default_factory=time.time)
    # wall-clock of the LOCAL transition into FAILED (0 while not
    # failed): autopilot's dead-server grace runs from this, not
    # last_seen — last_seen goes stale for healthy-but-unprobed members,
    # which would zero out the grace period
    failed_since: float = 0.0


class Gossip:
    def __init__(
        self,
        name: str,
        addr: str,
        region: str,
        rpc_server,
        seeds: list[str] | None = None,
        interval: float = 1.0,
        rng: random.Random | None = None,
    ):
        self.name = name
        self.addr = addr
        self.region = region
        self.interval = interval
        self._rng = rng if rng is not None else random.Random(f"gossip:{name}")
        self.seeds = [s for s in (seeds or []) if s != addr]
        self._lock = threading.Lock()
        self.members: dict[str, Member] = {
            name: Member(name=name, addr=addr, region=region)
        }
        self._probe_failures: dict[str, int] = {}
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._clients: dict[str, RPCClient] = {}
        rpc_server.register("Nomad.gossip_sync", self._handle_sync)

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> None:
        self._thread = threading.Thread(
            target=self._loop, name=f"gossip-{self.name}", daemon=True
        )
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        if self._thread:
            self._thread.join(timeout=2)
        for c in self._clients.values():
            c.close()

    # -- table -------------------------------------------------------------
    def _table_wire(self) -> list[dict]:
        with self._lock:
            return [asdict(m) for m in self.members.values()]

    def merge(self, remote: list[dict]) -> None:
        with self._lock:
            for d in remote:
                m = Member(**d)
                if m.name == self.name:
                    # refutation (SWIM): a rumor of our death is answered
                    # with a fresher incarnation
                    me = self.members[self.name]
                    if (
                        m.status != STATUS_ALIVE
                        and m.incarnation >= me.incarnation
                    ):
                        me.incarnation = m.incarnation + 1
                        me.status = STATUS_ALIVE
                    continue
                cur = self.members.get(m.name)
                if cur is None or m.incarnation > cur.incarnation:
                    m.last_seen = time.time()
                    # failed_since is a LOCAL clock stamp (autopilot's
                    # grace timer) — never adopt a remote's: keep ours if
                    # already failed, else stamp the transition now
                    if m.status == STATUS_FAILED:
                        m.failed_since = (
                            cur.failed_since
                            if cur is not None
                            and cur.status == STATUS_FAILED
                            and cur.failed_since
                            else time.time()
                        )
                    else:
                        m.failed_since = 0.0
                    self.members[m.name] = m
                    if m.status == STATUS_ALIVE:
                        # revival resets the probe count — otherwise one
                        # later transient timeout jumps straight to FAILED
                        self._probe_failures.pop(m.addr, None)
                elif m.incarnation == cur.incarnation:
                    # equal incarnation: suspicion/death rumors win
                    rank = {STATUS_ALIVE: 0, STATUS_SUSPECT: 1, STATUS_FAILED: 2}
                    if rank.get(m.status, 0) > rank.get(cur.status, 0):
                        if (
                            m.status == STATUS_FAILED
                            and cur.status != STATUS_FAILED
                        ):
                            cur.failed_since = time.time()
                        cur.status = m.status

    def _handle_sync(self, args):
        self.merge(args.get("members") or [])
        return {"members": self._table_wire()}

    # -- anti-entropy loop -------------------------------------------------
    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                self._sync_once()
            except Exception:
                log.exception("gossip sync round failed")
            self._stop.wait(self.interval)

    def _targets(self) -> list[str]:
        with self._lock:
            addrs = [
                m.addr
                for m in self.members.values()
                if m.name != self.name and m.status != STATUS_FAILED
            ]
        for s in self.seeds:
            if s not in addrs:
                addrs.append(s)
        return addrs

    def _sync_once(self) -> None:
        targets = self._targets()
        if not targets:
            return
        addr = self._rng.choice(targets)
        client = self._clients.get(addr)
        if client is None:
            client = self._clients[addr] = RPCClient(addr, timeout=2.0)
        try:
            resp = client.call(
                "Nomad.gossip_sync", {"members": self._table_wire()}
            )
        except (ConnectionError, TimeoutError, OSError):
            self._clients.pop(addr, None)
            client.close()
            self._mark_unreachable(addr)
            return
        self._probe_failures.pop(addr, None)
        self._mark_alive(addr)
        self.merge(resp.get("members") or [])

    def _mark_alive(self, addr: str) -> None:
        """Direct successful contact: a LOCAL liveness observation.

        SWIM incarnation ownership: only a member may bump its own
        incarnation (refutation, memberlist's alive/suspect protocol) —
        fabricating a higher incarnation here would let two partitioned
        observers leapfrog each other indefinitely and suppress the
        member's own genuine status updates cluster-wide. Status flips to
        ALIVE at the member's current incarnation; a stale equal-
        incarnation suspect rumor may override it transiently, and the
        member then refutes with its own fresher incarnation on the next
        sync it participates in — the convergent SWIM path."""
        with self._lock:
            for m in self.members.values():
                if m.addr == addr:
                    m.status = STATUS_ALIVE
                    m.failed_since = 0.0
                    m.last_seen = time.time()

    def _mark_unreachable(self, addr: str) -> None:
        n = self._probe_failures.get(addr, 0) + 1
        self._probe_failures[addr] = n
        with self._lock:
            for m in self.members.values():
                if m.addr != addr or m.name == self.name:
                    continue
                if n >= FAILED_AFTER and m.status != STATUS_FAILED:
                    m.status = STATUS_FAILED
                    m.failed_since = time.time()
                    log.info("gossip: member %s failed", m.name)
                elif n >= SUSPECT_AFTER and m.status == STATUS_ALIVE:
                    m.status = STATUS_SUSPECT

    # -- derived views -----------------------------------------------------
    def members_snapshot(self) -> dict[str, Member]:
        """Point-in-time copy of the member table (autopilot input)."""
        with self._lock:
            return {
                name: Member(**asdict(m)) for name, m in self.members.items()
            }

    def alive_members(self) -> list[Member]:
        with self._lock:
            return [
                Member(**asdict(m))
                for m in self.members.values()
                if m.status == STATUS_ALIVE
            ]

    def region_peers(self) -> dict[str, list[str]]:
        """Foreign region → reachable server addrs (the WAN federation
        map the reference derives from Serf, nomad/rpc.go forwardRegion)."""
        out: dict[str, list[str]] = {}
        with self._lock:
            for m in self.members.values():
                if m.region != self.region and m.status == STATUS_ALIVE:
                    out.setdefault(m.region, []).append(m.addr)
        return out
