"""RaftNode — leader election, log replication, commitment, snapshots.

Reference: hashicorp/raft as wired by nomad/server.go:105-109 (transport:
nomad/raft_rpc.go RaftLayer; log store: raft-boltdb). The protocol here is
standard Raft (elections with randomized timeouts, log-matching append
entries, majority commitment, snapshot install for lagging followers),
persisted in the native C++ WAL (term/vote in its KV, entries in the
segmented log) and transported over nomad_tpu_torch.rpc.

Scope notes vs hashicorp/raft: peer ADDITION is static per process
lifetime (join = restart with new config); peer REMOVAL is dynamic — a
RAFT_REMOVE_PEER entry committed through the log (the single-server
membership-change special case; hashicorp/raft RemoveServer), consumed by
autopilot dead-server cleanup (nomad/autopilot.go) and `operator raft
remove-peer` (command/operator_raft_remove.go). Pre-vote and leadership
transfer are not implemented.

The JAX package's ``raft/node.py`` with its imports rewritten, and two
departures: the durable removed-peer set is read back through
``rpc/framing.restricted_loads`` (as log entries already are), not bare
``pickle.loads``; and the election timeout draws from
``RaftConfig.rng``, a ``random.Random`` seeded from the node id unless
the caller passes one, not from the module-level generator.
"""

from __future__ import annotations

import logging
import os
import pickle
import random
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field
from typing import Any, Dict, Optional, Tuple

from ..rpc import RPCClient

log = logging.getLogger(__name__)

FOLLOWER = "follower"
CANDIDATE = "candidate"
LEADER = "leader"

MAX_BATCH_ENTRIES = 512
SNAP_THRESHOLD_ENTRIES = 8192


class NotLeaderError(Exception):
    def __init__(self, leader_id: Optional[str], leader_addr: Optional[str]):
        super().__init__(f"not the leader (leader={leader_id})")
        self.leader_id = leader_id
        self.leader_addr = leader_addr


@dataclass
class RaftConfig:
    node_id: str
    peers: Dict[str, str]  # node_id -> rpc address (includes self)
    data_dir: Optional[str] = None
    election_timeout_min: float = 0.15
    election_timeout_max: float = 0.30
    heartbeat_interval: float = 0.05
    snapshot_threshold: int = SNAP_THRESHOLD_ENTRIES
    rpc_timeout: float = 2.0
    # the election timeout's generator: a test fixes it; by default one
    # seeded from the node id, so that two servers draw apart
    rng: Optional[random.Random] = None

    def __post_init__(self):
        if self.rng is None:
            self.rng = random.Random(f"raft:{self.node_id}")


class _MemLog:
    """In-memory log (tests / diskless mode); mirrors the WAL interface."""

    def __init__(self):
        self._e: dict[int, tuple[int, int, bytes]] = {}
        self._first = 0
        self._last = 0
        self._kv: dict[str, bytes] = {}

    def first_index(self):
        return self._first

    def last_index(self):
        return self._last

    def append(self, index, term, type_, data):
        self._e[index] = (term, type_, data)
        if self._first == 0:
            self._first = index
        self._last = index

    def get(self, index):
        if index not in self._e:
            raise KeyError(index)
        return self._e[index]

    def truncate_suffix(self, from_index):
        for i in range(from_index, self._last + 1):
            self._e.pop(i, None)
        if from_index <= self._first:
            self._first = self._last = 0
        else:
            self._last = from_index - 1

    def compact_prefix(self, to_index):
        for i in range(self._first, min(to_index, self._last) + 1):
            self._e.pop(i, None)
        if self._e:
            self._first = min(self._e)
        else:
            self._first = self._last = 0

    def sync(self):
        pass

    def close(self):
        pass

    def kv_set(self, k, v):
        self._kv[k] = v

    def kv_get(self, k):
        return self._kv.get(k)


class RaftNode:
    def __init__(self, config: RaftConfig, fsm,
                 snapshot_fn=None, restore_fn=None,
                 on_leader=None, on_follower=None):
        self.config = config
        self.fsm = fsm
        self.snapshot_fn = snapshot_fn
        self.restore_fn = restore_fn
        self.on_leader = on_leader      # establishLeadership hook
        self.on_follower = on_follower  # revokeLeadership hook

        if config.data_dir:
            from ..native import WalStore

            os.makedirs(config.data_dir, exist_ok=True)
            self.log = WalStore(os.path.join(config.data_dir, "raft"))
        else:
            self.log = _MemLog()

        self._mu = threading.RLock()
        self.state = FOLLOWER
        self.term = self._load_u64("term")
        self.voted_for = self._load_str("voted_for")
        # Membership survives restart/compaction: a committed
        # RAFT_REMOVE_PEER persists the REMOVED-PEER SET (and our own
        # removed flag) in the node's durable KV. Without this, a restart
        # would revert to the full peer set and a restarted removed
        # server could campaign again — with enough reverted servers, two
        # disjoint quorums (split brain). Persisting the removed SET (not
        # the whole peer map) keeps the documented join-by-restart path
        # working: new peers and address changes still flow from the
        # static startup config; only removals are subtracted. Re-adding
        # a removed server requires wiping its entry (fresh data-dir /
        # operator action), the same contract as hashicorp/raft.
        # the durable KV is read like anything a peer could have written:
        # through the allowlist, not bare pickle
        from ..rpc.framing import restricted_loads

        removed_blob = self.log.kv_get("removed_peers")
        self._removed_peers: set = (
            restricted_loads(removed_blob) if removed_blob else set()
        )
        for rid in self._removed_peers:
            if rid != config.node_id:
                self.config.peers.pop(rid, None)
        self._removed_persisted = self.log.kv_get("removed") == b"1"
        self.leader: Optional[str] = None
        self.commit_index = 0
        self.last_applied = 0
        # snapshot bookkeeping: term of the entry the snapshot subsumes
        self.snap_index = self._load_u64("snap_index")
        self.snap_term = self._load_u64("snap_term")

        self._last_contact = time.monotonic()
        self._timeout = self._rand_timeout()
        self._closed = False
        self._stop = threading.Event()
        self._threads: list[threading.Thread] = []
        self._futures: dict[int, Future] = {}
        self._apply_cv = threading.Condition(self._mu)
        # serializes FSM mutation between the applier loop and
        # InstallSnapshot restore; always acquired BEFORE _mu
        self._apply_serial = threading.Lock()
        self._repl_events: dict[str, threading.Event] = {}
        self._clients: dict[str, RPCClient] = {}
        self._match_index: dict[str, int] = {}
        self._next_index: dict[str, int] = {}
        self._entries_since_snap = 0
        # set when a committed membership change removed THIS server from
        # the voting set: it stops starting elections (a removed server
        # kicking off term churn is the classic disruption autopilot's
        # dead-server cleanup exists to avoid)
        self._removed = self._removed_persisted
        # lame-duck replication: a peer removed from the config keeps
        # receiving append_entries until it ACKS the removal entry (so a
        # LIVE removed server learns it was removed instead of election-
        # timing-out and disrupting the survivors) or the grace expires
        # (a DEAD one can't ack). peer_id -> (removal_index, deadline).
        self._lame_ducks: dict[str, tuple[int, float]] = {}

    # -- persistence helpers ----------------------------------------------
    def _load_u64(self, key: str) -> int:
        v = self.log.kv_get(key)
        return int.from_bytes(v, "little") if v else 0

    def _load_str(self, key: str) -> Optional[str]:
        v = self.log.kv_get(key)
        return v.decode() if v else None

    def _persist_term_vote(self) -> None:
        self.log.kv_set("term", self.term.to_bytes(8, "little"))
        self.log.kv_set("voted_for", (self.voted_for or "").encode())

    def _persist_snap_meta(self) -> None:
        self.log.kv_set("snap_index", self.snap_index.to_bytes(8, "little"))
        self.log.kv_set("snap_term", self.snap_term.to_bytes(8, "little"))

    def _persist_membership_locked(self) -> None:
        """Durable membership: the config change must survive restart and
        log compaction (the removal entry itself can be compacted away).
        Only the removed SET is persisted — additions and address changes
        keep flowing from the static startup config."""
        self.log.kv_set(
            "removed_peers",
            pickle.dumps(self._removed_peers, pickle.HIGHEST_PROTOCOL),
        )
        self.log.kv_set("removed", b"1" if self._removed else b"0")
        self.log.sync()

    def _snap_path(self) -> str:
        return os.path.join(self.config.data_dir or "", "state.snap")

    # -- lifecycle ---------------------------------------------------------
    def start(self, rpc_server) -> None:
        """Register RPC handlers and start the election ticker. Boot-time
        recovery: restore newest snapshot, then trust the log (entries
        re-commit via normal protocol)."""
        if self.config.data_dir and self.restore_fn is not None and (
            os.path.exists(self._snap_path())
        ):
            self.restore_fn(self._snap_path())
        with self._mu:
            self.last_applied = self.fsm.store.latest_index
            self.commit_index = self.last_applied
        rpc_server.register("Raft.request_vote", self._handle_request_vote)
        rpc_server.register("Raft.append_entries", self._handle_append_entries)
        rpc_server.register("Raft.install_snapshot", self._handle_install_snapshot)
        t = threading.Thread(target=self._ticker, name="raft-ticker", daemon=True)
        t.start()
        self._threads.append(t)
        t2 = threading.Thread(target=self._applier, name="raft-apply", daemon=True)
        t2.start()
        self._threads.append(t2)

    def shutdown(self) -> None:
        self._stop.set()
        for ev in self._repl_events.values():
            ev.set()
        for c in self._clients.values():
            c.close()
        # close under _mu: every log access holds _mu, so this cannot race
        # an in-flight RPC handler into a use-after-free of the native WAL
        with self._mu:
            self._apply_cv.notify_all()
            if not self._closed:  # shutdown is idempotent
                self._closed = True
                self.log.sync()
                self.log.close()

    # -- helpers -----------------------------------------------------------
    def _rand_timeout(self) -> float:
        return self.config.rng.uniform(
            self.config.election_timeout_min, self.config.election_timeout_max
        )

    def _client(self, peer_id: str) -> RPCClient:
        c = self._clients.get(peer_id)
        if c is None:
            # raft supplies its own retry cadence (heartbeat interval,
            # election timer); transport-level dial retries would stall
            # the timing the protocol depends on
            c = RPCClient(
                self.config.peers[peer_id], timeout=self.config.rpc_timeout,
                max_attempts=1,
            )
            self._clients[peer_id] = c
        return c

    def _last_log(self) -> Tuple[int, int]:
        """(last_index, last_term) including snapshot tail."""
        li = self.log.last_index()
        if li == 0:
            return self.snap_index, self.snap_term
        term, _t, _d = self.log.get(li)
        return li, term

    def _term_at(self, index: int) -> Optional[int]:
        if index == 0:
            return 0
        if index == self.snap_index:
            return self.snap_term
        try:
            term, _t, _d = self.log.get(index)
            return term
        except KeyError:
            return None

    def is_leader(self) -> bool:
        return self.state == LEADER

    def peers(self) -> Dict[str, str]:
        """Current voting configuration (node_id -> addr), self included."""
        with self._mu:
            return dict(self.config.peers)

    def remove_peer(self, node_id: str, timeout: float = 10.0) -> None:
        """Leader-only: commit a membership change removing ``node_id``
        from the voting set (autopilot / operator raft remove-peer). The
        change takes effect on each server as the entry applies; the
        removed server stops participating (no elections, no votes)."""
        from ..server.fsm import MsgType

        with self._mu:
            if node_id not in self.config.peers:
                raise ValueError(f"unknown raft peer {node_id!r}")
            if node_id == self.config.node_id:
                raise ValueError("cannot remove the current leader; "
                                 "transfer leadership first")
        self.apply(MsgType.RAFT_REMOVE_PEER, {"node_id": node_id},
                   timeout=timeout)

    def leader_id(self) -> Optional[str]:
        return self.leader

    def leader_addr(self) -> Optional[str]:
        return self.config.peers.get(self.leader) if self.leader else None

    def stats(self) -> dict:
        with self._mu:
            return {
                "state": self.state.capitalize(),
                "term": self.term,
                "leader": self.leader,
                "last_log_index": self._last_log()[0],
                "commit_index": self.commit_index,
                "applied_index": self.last_applied,
                "num_peers": len(self.config.peers) - 1,
                "snapshot_index": self.snap_index,
            }

    # -- public write path -------------------------------------------------
    def apply(self, mtype: int, payload: Optional[dict] = None,
              timeout: float = 10.0) -> Tuple[int, Any]:
        """Leader-only: append, replicate, wait for commit+apply, return
        (index, fsm_result). Raises NotLeaderError for forwarding."""
        with self._mu:
            if self._stop.is_set():
                raise NotLeaderError(None, None)
            if self.state != LEADER:
                raise NotLeaderError(self.leader, self.leader_addr())
            index = self._last_log()[0] + 1
            data = pickle.dumps(payload, pickle.HIGHEST_PROTOCOL)
            self.log.append(index, self.term, int(mtype), data)
            # Raft stable-storage rule: the leader's own vote toward the
            # commit majority only counts once the entry is durable — an
            # acked commit must survive leader power loss (followers fsync
            # in _handle_append_entries; the leader must too).
            self.log.sync()
            fut: Future = Future()
            self._futures[index] = fut
            self._maybe_advance_commit_locked()
        for ev in self._repl_events.values():
            ev.set()
        try:
            return index, fut.result(timeout=timeout)
        except TimeoutError:
            self._futures.pop(index, None)
            raise TimeoutError(
                f"raft apply at index {index} not committed within {timeout}s"
            ) from None

    def barrier(self, timeout: float = 10.0) -> int:
        from ..server.fsm import MsgType

        index, _ = self.apply(MsgType.NOOP, None, timeout=timeout)
        return index

    # -- ticker / elections ------------------------------------------------
    def _ticker(self) -> None:
        while not self._stop.wait(0.01):
            with self._mu:
                if self._stop.is_set():  # shutdown raced our wait: the log
                    return                # may already be closed
                if self.state == LEADER or self._removed:
                    continue
                if time.monotonic() - self._last_contact < self._timeout:
                    continue
                # election time
                self.state = CANDIDATE
                self.term += 1
                self.voted_for = self.config.node_id
                self._persist_term_vote()
                term = self.term
                self._last_contact = time.monotonic()
                self._timeout = self._rand_timeout()
                window = self._timeout
                last_index, last_term = self._last_log()
            self._run_election(term, last_index, last_term, window)

    def _run_election(self, term: int, last_index: int, last_term: int,
                      window: float) -> None:
        votes = [self.config.node_id]  # self-vote
        vote_mu = threading.Lock()
        done = threading.Event()
        majority = len(self.config.peers) // 2 + 1

        def ask(peer_id: str) -> None:
            try:
                resp = self._client(peer_id).call(
                    "Raft.request_vote",
                    {
                        "term": term,
                        "candidate_id": self.config.node_id,
                        "last_log_index": last_index,
                        "last_log_term": last_term,
                    },
                    timeout=self.config.rpc_timeout,
                )
            except Exception:
                return
            with self._mu:
                if resp["term"] > self.term:
                    self._step_down_locked(resp["term"])
                    done.set()
                    return
            if resp.get("granted"):
                with vote_mu:
                    votes.append(peer_id)
                    if len(votes) >= majority:
                        done.set()

        others = [p for p in self.config.peers if p != self.config.node_id]
        for p in others:
            threading.Thread(target=ask, args=(p,), daemon=True).start()
        if not others:
            done.set()
        # hold the candidacy open for the full randomized election window
        # (Raft §5.2): under load, grants can arrive later than a fixed
        # short wait, and discarding them forces needless re-elections
        deadline = time.monotonic() + window
        while not done.wait(timeout=0.02):
            with self._mu:
                if self.state != CANDIDATE or self.term != term:
                    return
            with vote_mu:
                if len(votes) >= majority:
                    break
            if time.monotonic() > deadline:
                break
        with self._mu:
            if self.state != CANDIDATE or self.term != term:
                return
            if len(votes) >= majority:
                self._become_leader_locked()

    def _become_leader_locked(self) -> None:
        log.info(
            "raft: %s won election for term %d", self.config.node_id, self.term
        )
        self.state = LEADER
        self.leader = self.config.node_id
        last, _ = self._last_log()
        self._next_index = {
            p: last + 1 for p in self.config.peers if p != self.config.node_id
        }
        self._match_index = {
            p: 0 for p in self.config.peers if p != self.config.node_id
        }
        # barrier entry: commits everything from prior terms (Raft §5.4.2 —
        # a leader may only count replicas for entries of its own term)
        from ..server.fsm import MsgType

        index = last + 1
        self.log.append(index, self.term, int(MsgType.NOOP), pickle.dumps(None))
        self.log.sync()  # durable before counting toward the majority
        self._maybe_advance_commit_locked()
        for p in self._next_index:
            ev = threading.Event()
            ev.set()
            self._repl_events[p] = ev
            t = threading.Thread(
                target=self._replicate_loop, args=(p, self.term),
                name=f"raft-repl-{p}", daemon=True,
            )
            t.start()
        if self.on_leader is not None:
            threading.Thread(target=self.on_leader, daemon=True).start()

    def _step_down_locked(self, new_term: int) -> None:
        was_leader = self.state == LEADER
        if new_term > self.term:
            self.term = new_term
            self.voted_for = None
            self._persist_term_vote()
        self.state = FOLLOWER
        self._last_contact = time.monotonic()
        self._timeout = self._rand_timeout()
        if was_leader:
            # fail in-flight futures: commitment now unknown
            for fut in self._futures.values():
                if not fut.done():
                    fut.set_exception(NotLeaderError(self.leader, None))
            self._futures.clear()
            if self.on_follower is not None:
                threading.Thread(target=self.on_follower, daemon=True).start()

    # -- replication (leader) ----------------------------------------------
    def _replicate_loop(self, peer_id: str, term: int) -> None:
        ev = self._repl_events[peer_id]
        while not self._stop.is_set():
            ev.wait(timeout=self.config.heartbeat_interval)
            ev.clear()
            with self._mu:
                if self._stop.is_set() or self.state != LEADER or (
                    self.term != term
                ):
                    return
                if peer_id not in self.config.peers:
                    duck = self._lame_ducks.get(peer_id)
                    if duck is None or time.monotonic() > duck[1]:
                        self._finalize_removed_peer_locked(peer_id)
                        return
                    # lame duck: keep feeding it the removal entry (and
                    # the commit index covering it — it ACKS the entry
                    # before it learns the commit, so finalizing on match
                    # alone would strand it unaware, election-timing-out)
                if peer_id not in self._next_index:
                    return
                next_idx = self._next_index[peer_id]
                first = self.log.first_index()
                need_snapshot = (
                    self.snap_index > 0 and next_idx <= self.snap_index and (
                        first == 0 or next_idx < first
                    )
                )
                if not need_snapshot:
                    batch, prev_index, prev_term, ok = (
                        self._build_batch_locked(next_idx)
                    )
                    if not ok:
                        need_snapshot = self.snap_index > 0
                commit = self.commit_index
            if need_snapshot:
                self._send_snapshot(peer_id, term)
                continue
            try:
                resp = self._client(peer_id).call(
                    "Raft.append_entries",
                    {
                        "term": term,
                        "leader_id": self.config.node_id,
                        "prev_log_index": prev_index,
                        "prev_log_term": prev_term,
                        "entries": batch,
                        "leader_commit": commit,
                    },
                    timeout=self.config.rpc_timeout,
                )
            except Exception:
                continue  # retry next tick
            with self._mu:
                if self.state != LEADER or self.term != term:
                    return
                is_duck = peer_id in self._lame_ducks
                if peer_id not in self.config.peers and not is_duck:
                    return
                if resp["term"] > self.term:
                    if is_duck:
                        # a removed-but-unaware server camps on inflated
                        # terms from its futile elections; its responses
                        # must not dethrone the surviving leader
                        continue
                    self._step_down_locked(resp["term"])
                    return
                if resp.get("success"):
                    if batch:
                        self._match_index[peer_id] = batch[-1][0]
                        self._next_index[peer_id] = batch[-1][0] + 1
                        self._maybe_advance_commit_locked()
                        if self._next_index[peer_id] <= self._last_log()[0]:
                            ev.set()  # more to send
                    duck = self._lame_ducks.get(peer_id)
                    if duck is not None and (
                        commit >= duck[0]
                        and self._match_index.get(peer_id, 0) >= duck[0]
                    ):
                        # the removed peer has stored the removal entry
                        # AND seen a commit index covering it — it will
                        # apply its own removal; drain complete
                        self._finalize_removed_peer_locked(peer_id)
                        return
                else:
                    conflict = resp.get("conflict_index") or max(
                        1, self._next_index[peer_id] - 1
                    )
                    self._next_index[peer_id] = max(1, min(
                        conflict, self._next_index[peer_id] - 1,
                    ))
                    ev.set()

    def _build_batch_locked(self, next_idx: int):
        """Returns (entries, prev_index, prev_term, ok). ok=False when the
        prev entry has been compacted away (snapshot needed)."""
        last = self.log.last_index()
        prev_index = next_idx - 1
        prev_term = self._term_at(prev_index)
        if prev_term is None:
            return [], 0, 0, False
        batch = []
        for i in range(next_idx, min(last, next_idx + MAX_BATCH_ENTRIES - 1) + 1):
            try:
                e_term, e_type, e_data = self.log.get(i)
            except KeyError:
                break
            batch.append((i, e_term, e_type, e_data))
        return batch, prev_index, prev_term, True

    def _maybe_advance_commit_locked(self) -> None:
        if self.state != LEADER:
            return
        last, _ = self._last_log()
        # lame-duck (removed) peers may still have match entries while
        # their removal entry drains to them — they are NOT voters
        matches = sorted(
            [
                m
                for p, m in self._match_index.items()
                if p in self.config.peers
            ]
            + [last],
            reverse=True,
        )
        majority_at = matches[len(self.config.peers) // 2]
        if majority_at > self.commit_index and (
            self._term_at(majority_at) == self.term
        ):
            self.commit_index = majority_at
            self._apply_cv.notify_all()

    def _send_snapshot(self, peer_id: str, term: int) -> None:
        """InstallSnapshot: ship the whole state snapshot (fsm.go Restore
        path; hashicorp/raft sends it chunked — ours fits one frame for the
        state sizes in scope)."""
        if self.snapshot_fn is None or not self.config.data_dir:
            return
        path = self._snap_path()
        if not os.path.exists(path):
            with self._mu:
                self._take_snapshot_locked()
        try:
            with open(path, "rb") as f:
                blob = f.read()
        except OSError:
            return
        with self._mu:
            snap_index, snap_term = self.snap_index, self.snap_term
            peers_now = dict(self.config.peers)
        try:
            resp = self._client(peer_id).call(
                "Raft.install_snapshot",
                {
                    "term": term,
                    "leader_id": self.config.node_id,
                    "last_included_index": snap_index,
                    "last_included_term": snap_term,
                    "data": blob,
                    # membership rides along: the compacted log may no
                    # longer carry the RAFT_REMOVE_PEER entries, so a
                    # bootstrapped follower must adopt the current voter
                    # set or it would revert to its stale startup config
                    "peers": peers_now,
                },
                timeout=max(self.config.rpc_timeout, 10.0),
            )
        except Exception:
            return
        with self._mu:
            if resp["term"] > self.term:
                self._step_down_locked(resp["term"])
                return
            self._match_index[peer_id] = max(
                self._match_index.get(peer_id, 0), snap_index
            )
            self._next_index[peer_id] = snap_index + 1

    # -- RPC handlers (any state) ------------------------------------------
    def _handle_request_vote(self, args: dict) -> dict:
        with self._mu:
            if self._stop.is_set():
                return {"term": self.term, "granted": False}
            if args["candidate_id"] not in self.config.peers:
                # a server removed from the configuration (that may not
                # know it yet) must not be able to disrupt the cluster:
                # refuse WITHOUT adopting its inflated term
                # (hashicorp/raft ignores RequestVote from non-members)
                return {"term": args["term"], "granted": False}
            if args["term"] < self.term:
                return {"term": self.term, "granted": False}
            if args["term"] > self.term:
                self._step_down_locked(args["term"])
            last_index, last_term = self._last_log()
            up_to_date = (args["last_log_term"], args["last_log_index"]) >= (
                last_term, last_index,
            )
            if up_to_date and self.voted_for in (None, args["candidate_id"]):
                self.voted_for = args["candidate_id"]
                self._persist_term_vote()
                self._last_contact = time.monotonic()
                return {"term": self.term, "granted": True}
            return {"term": self.term, "granted": False}

    def _handle_append_entries(self, args: dict) -> dict:
        with self._mu:
            if self._stop.is_set():
                return {"term": self.term, "success": False}
            if args["term"] < self.term:
                return {"term": self.term, "success": False}
            if args["term"] > self.term or self.state != FOLLOWER:
                self._step_down_locked(args["term"])
            self.leader = args["leader_id"]
            self._last_contact = time.monotonic()

            prev_index, prev_term = args["prev_log_index"], args["prev_log_term"]
            local_prev_term = self._term_at(prev_index)
            if prev_index < self.snap_index:
                # already subsumed by our snapshot: report what we have
                return {
                    "term": self.term, "success": False,
                    "conflict_index": self.snap_index + 1,
                }
            if local_prev_term is None:
                return {
                    "term": self.term, "success": False,
                    "conflict_index": self._last_log()[0] + 1,
                }
            if local_prev_term != prev_term:
                return {
                    "term": self.term, "success": False,
                    "conflict_index": max(self.snap_index + 1, prev_index),
                }
            for index, e_term, e_type, e_data in args["entries"]:
                existing = self._term_at(index)
                if existing is not None and existing != e_term:
                    self.log.truncate_suffix(index)
                    existing = None
                if existing is None:
                    if self.log.last_index() not in (index - 1, 0) and (
                        index != self.snap_index + 1
                    ):
                        # gap would violate contiguity — reject; leader backs up
                        return {
                            "term": self.term, "success": False,
                            "conflict_index": self._last_log()[0] + 1,
                        }
                    self.log.append(index, e_term, e_type, e_data)
            if args["entries"]:
                self.log.sync()
            last_new = args["entries"][-1][0] if args["entries"] else prev_index
            if args["leader_commit"] > self.commit_index:
                self.commit_index = min(args["leader_commit"], last_new)
                self._apply_cv.notify_all()
            return {"term": self.term, "success": True, "match_index": last_new}

    def _handle_install_snapshot(self, args: dict) -> dict:
        # _apply_serial makes the restore atomic w.r.t. the applier's
        # check-then-apply of individual log entries (lock order:
        # _apply_serial before _mu)
        with self._apply_serial, self._mu:
            if self._stop.is_set() or args["term"] < self.term:
                return {"term": self.term}
            if args["term"] > self.term or self.state != FOLLOWER:
                self._step_down_locked(args["term"])
            self.leader = args["leader_id"]
            self._last_contact = time.monotonic()
            idx = args["last_included_index"]
            if idx <= self.last_applied:
                return {"term": self.term}  # stale snapshot
            path = self._snap_path() if self.config.data_dir else None
            if path is None:
                import tempfile

                fd, path = tempfile.mkstemp(suffix=".snap")
                os.close(fd)
            # atomic: our log prefix may already be compacted behind the
            # previous snapshot, so tearing it on crash loses state
            from ..state.snapshot import atomic_write_bytes

            atomic_write_bytes(path, args["data"])
            self.restore_fn(path)
            self.snap_index = idx
            self.snap_term = args["last_included_term"]
            self._persist_snap_meta()
            peers = args.get("peers")
            if peers:
                # adopt the leader's voter set; peers that vanished join
                # the durable removed set so a restart (which re-derives
                # from static config minus removals) doesn't resurrect
                self._removed_peers |= set(self.config.peers) - set(peers)
                self.config.peers = dict(peers)
                if self.config.node_id not in self.config.peers:
                    self._removed = True
                self._persist_membership_locked()
            # discard the whole log: snapshot subsumes it
            self.log.truncate_suffix(1)
            self.last_applied = self.fsm.store.latest_index
            self.commit_index = max(self.commit_index, self.last_applied)
            return {"term": self.term}

    # -- apply loop --------------------------------------------------------
    def _applier(self) -> None:
        while not self._stop.is_set():
            with self._mu:
                while (
                    self.last_applied >= self.commit_index
                    and not self._stop.is_set()
                ):
                    self._apply_cv.wait(timeout=0.2)
                    if self._stop.is_set():
                        return
                start = self.last_applied + 1
                end = self.commit_index
                entries = []
                for i in range(start, end + 1):
                    try:
                        term, mtype, data = self.log.get(i)
                    except Exception:  # gone (compacted/closed at shutdown)
                        break
                    entries.append((i, mtype, data))
            for i, mtype, data in entries:
                # _apply_serial holds InstallSnapshot off for the duration
                # of one entry's check+apply+update: without it, a restore
                # could land between the staleness check and fsm.apply,
                # and the stale entry would be applied onto the restored
                # (newer) store.
                with self._apply_serial:
                    with self._mu:
                        # entries at or below last_applied/snap_index are
                        # already reflected in the restored store (and
                        # their log may be gone) — applying them again
                        # would regress the FSM
                        if i <= self.last_applied or i <= self.snap_index:
                            continue
                    # log entries can originate from the network
                    # (append_entries from any peer) — deserialize through
                    # the framework allowlist, not bare pickle
                    from ..rpc.framing import restricted_loads

                    payload = restricted_loads(data)
                    try:
                        result = self.fsm.apply(i, mtype, payload)
                        err = None
                    except Exception as e:  # noqa: BLE001 — surface to waiter
                        result, err = None, e
                    from ..server.fsm import MsgType

                    if mtype == int(MsgType.RAFT_REMOVE_PEER) and payload:
                        # membership change: committed, so every surviving
                        # replica applies the same config transition at
                        # the same log position
                        self._apply_remove_peer_config(
                            payload.get("node_id"), i
                        )
                    with self._mu:
                        self.last_applied = max(self.last_applied, i)
                        fut = self._futures.pop(i, None)
                        self._entries_since_snap += 1
                if fut is not None and not fut.done():
                    if err is not None:
                        fut.set_exception(err)
                    else:
                        fut.set_result(result)
            self._maybe_snapshot()

    def _apply_remove_peer_config(
        self, node_id: Optional[str], removal_index: int = 0
    ) -> None:
        """Config transition for a committed RAFT_REMOVE_PEER entry."""
        if not node_id:
            return
        with self._mu:
            if node_id == self.config.node_id:
                # we are the removed server: stop participating (no
                # elections; stale-term RPCs are answered but never won)
                self._removed = True
                self._removed_peers.add(node_id)
                self._persist_membership_locked()
                if self.state == LEADER:
                    self._step_down_locked(self.term)
                else:
                    self.state = FOLLOWER
                log.info("raft: this server (%s) removed from the "
                         "configuration", node_id)
                return
            if node_id not in self.config.peers:
                return
            del self.config.peers[node_id]
            self._removed_peers.add(node_id)
            self._persist_membership_locked()
            if self.state == LEADER:
                # lame-duck: keep replicating the removal entry to the
                # (possibly live) removed peer so it learns and stops
                # electing; the loop finalizes on ack or deadline
                self._lame_ducks[node_id] = (
                    removal_index, time.monotonic() + 5.0
                )
                ev = self._repl_events.get(node_id)
                if ev is not None:
                    ev.set()
            else:
                self._match_index.pop(node_id, None)
                self._next_index.pop(node_id, None)
            log.info("raft: removed peer %s; %d voters remain",
                     node_id, len(self.config.peers))
            # quorum shrank — entries may now be committed
            self._maybe_advance_commit_locked()

    def _finalize_removed_peer_locked(self, node_id: str) -> None:
        """Drop the replication machinery for a removed peer once its
        lame-duck window closes (ack of the removal entry or timeout)."""
        self._lame_ducks.pop(node_id, None)
        self._match_index.pop(node_id, None)
        self._next_index.pop(node_id, None)
        self._repl_events.pop(node_id, None)
        client = self._clients.pop(node_id, None)
        if client is not None:
            # close outside _mu is ideal, but close() only shuts a socket
            threading.Thread(target=client.close, daemon=True).start()

    def _maybe_snapshot(self) -> None:
        if (
            self.snapshot_fn is None
            or not self.config.data_dir
            or self._entries_since_snap < self.config.snapshot_threshold
        ):
            return
        with self._mu:
            self._take_snapshot_locked()

    def _take_snapshot_locked(self) -> None:
        index = self.last_applied
        if index == 0:
            return
        term = self._term_at(index) or self.snap_term
        self.snapshot_fn(self._snap_path())
        self.snap_index = index
        self.snap_term = term
        self._persist_snap_meta()
        self.log.compact_prefix(index)
        self.log.sync()
        self._entries_since_snap = 0

    def snapshot(self) -> int:
        with self._mu:
            self._take_snapshot_locked()
            return self.snap_index
