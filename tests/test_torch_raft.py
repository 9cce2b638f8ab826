"""The port's consensus node (``nomad_tpu_torch.raft.RaftNode``) against
the JAX package's, on the CPU: the scenarios of ``tests/test_raft.py``
and of ``tests/test_autopilot.py``'s ``TestRaftPeerRemoval``, each run on
both packages at once, in-process clusters over real TCP RPC.

Both sides get the same script, the reference's ``FAST`` timings (the
election timeout raised, ``ELECTION``) and fixed election generators (the port's ``RaftConfig.rng``; the reference's
module-level ``random`` replaced by a seeded ``random.Random`` for the
test). What is compared:

- the committed log: every replica of a side holds the same
  ``(index, type, payload, result)`` rows, and the two sides hold the
  same ``(type, payload, result)`` rows in index order (the election
  barriers, NOOP rows, are left out: how many there are follows election
  timing). Concurrent writers commit in the threads' order, so that
  scenario compares the rows as sets;
- the FSM's key/value state, and the error a follower raises;
- the survivors' peer sets after a removal, and the removed flags.

Every wait has its own deadline; every cluster stops in ``finally``.
``both``, ``in_turn`` and ``wait_until`` serve ``test_torch_cluster.py``
and ``test_torch_gossip.py`` too.

Tolerance: exact.
"""

import dataclasses
import pickle
import random
import shutil
import threading
import time
import types

import pytest

import nomad_tpu.raft.node as ref_node_mod
import nomad_tpu.server.gossip as ref_gossip_mod
from nomad_tpu import mock as ref_mock
from nomad_tpu.api.http import HTTPAgent as RefHTTPAgent
from nomad_tpu.client.client import Client as RefClient
from nomad_tpu.raft import NotLeaderError as RefNotLeader
from nomad_tpu.raft import RaftNode as RefRaftNode
from nomad_tpu.raft.node import RaftConfig as RefRaftConfig
from nomad_tpu.rpc import RPCClient as RefRPCClient
from nomad_tpu.rpc import RPCServer as RefRPCServer
from nomad_tpu.server import gossip as ref_gossip
from nomad_tpu.server.cluster import ClusterServer as RefClusterServer
from nomad_tpu.server.cluster import RemoteClientRPC as RefRemoteClientRPC
from nomad_tpu.server.fsm import FSM as RefFSM
from nomad_tpu.server.fsm import MsgType as RefMsgType
from nomad_tpu.server.server import Server as RefServer
from nomad_tpu.server.server import ServerConfig as RefServerConfig
from nomad_tpu_torch import interop
from nomad_tpu_torch.api.http import HTTPAgent
from nomad_tpu_torch.client.client import Client
from nomad_tpu_torch.raft import NotLeaderError, RaftNode
from nomad_tpu_torch.raft.node import RaftConfig
from nomad_tpu_torch.rpc import RPCClient, RPCServer
from nomad_tpu_torch.server import gossip as port_gossip
from nomad_tpu_torch.server.cluster import ClusterServer, RemoteClientRPC
from nomad_tpu_torch.server.fsm import FSM, MsgType
from nomad_tpu_torch.server.server import Server, ServerConfig
from nomad_tpu_torch.structs import Job, Node
from test_torch_hetero import reference_runtime

# the reference's FAST timings with the election timeout raised from
# 0.10–0.25 s: at that a follower loses its leader when the host is busy
# (six test workers at once, a second cluster in the process), and
# a scenario sees a leader change it did not script
ELECTION = dict(election_timeout_min=0.6, election_timeout_max=1.2)
FAST = dict(**ELECTION, heartbeat_interval=0.04, rpc_timeout=1.0)
# the cluster and gossip scenarios' timings (their reference files set no
# rpc_timeout)
CLUSTER_FAST = dict(**ELECTION, heartbeat_interval=0.04)
SEED = 17


def _port_of(obj, cls):
    return interop.from_record(cls, dataclasses.asdict(obj))


REF = types.SimpleNamespace(
    name="ref",
    RaftNode=RefRaftNode,
    RaftConfig=RefRaftConfig,
    NotLeaderError=RefNotLeader,
    RPCServer=RefRPCServer,
    RPCClient=RefRPCClient,
    MsgType=RefMsgType,
    FSM=RefFSM,
    Server=RefServer,
    ClusterServer=RefClusterServer,
    RemoteClientRPC=RefRemoteClientRPC,
    Client=RefClient,
    HTTPAgent=RefHTTPAgent,
    gossip=ref_gossip,
    config=lambda **kw: RefServerConfig(**kw),
    node=lambda n: n,
    job=lambda j: j,
)
PORT = types.SimpleNamespace(
    name="port",
    RaftNode=RaftNode,
    RaftConfig=RaftConfig,
    NotLeaderError=NotLeaderError,
    RPCServer=RPCServer,
    RPCClient=RPCClient,
    MsgType=MsgType,
    FSM=FSM,
    Server=Server,
    ClusterServer=ClusterServer,
    RemoteClientRPC=RemoteClientRPC,
    Client=Client,
    HTTPAgent=HTTPAgent,
    gossip=port_gossip,
    config=lambda **kw: ServerConfig(device="cpu", **kw),
    node=lambda n: _port_of(n, Node),
    job=lambda j: _port_of(j, Job),
)
SIDES = (REF, PORT)


@pytest.fixture(autouse=True)
def fixed_generators(monkeypatch):
    """The reference's module-level draws from seeded generators, and its
    traced_jit kernels on this jax (C-R1) for the test's whole life."""
    monkeypatch.setattr(ref_node_mod, "random", random.Random(SEED))
    monkeypatch.setattr(ref_gossip_mod, "random", random.Random(SEED + 1))
    with reference_runtime(monkeypatch):
        yield


def raft_rng(side, i):
    """Keyword arguments that fix the port's election generator."""
    return {} if side is REF else {"rng": random.Random(SEED * 100 + i)}


def both(fn, *args, timeout=120.0):
    """``fn(side, *args)`` on the reference and the port at once, each in
    its own thread; returns (reference's result, port's result)."""
    out, errs = {}, {}

    def run(side):
        try:
            out[side.name] = fn(side, *args)
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errs[side.name] = e

    ts = [threading.Thread(target=run, args=(s,), daemon=True) for s in SIDES]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout)
        assert not t.is_alive(), "a side did not finish"
    for name in ("ref", "port"):
        if name in errs:
            raise errs[name]
    return out["ref"], out["port"]


def in_turn(fn, *args):
    """``fn(side, *args)`` on the reference, then on the port: for the
    scenarios that schedule, whose workers' host passes, beside a second
    cluster in the same process, would starve its heartbeats."""
    return fn(REF, *args), fn(PORT, *args)


_WARM = []


def warm_reference():
    """The reference's placement programs traced once in this process
    before a cluster schedules: a first trace holds the interpreter lock
    for up to a second, past the election timeout of every cluster in the
    process, and a leader deposed mid-plan makes the reference place
    more allocs than a job's count. The shapes: one and two nodes,
    counts 1, 2, 3 and 10 (the scenarios' own)."""
    if _WARM:
        return
    s = RefServer(RefServerConfig(num_workers=1, heartbeat_ttl=3600.0))
    s.establish_leadership()
    try:
        s.register_node(ref_mock.node())
        for count in (1, 2, 3, 10):
            job = ref_mock.job()
            job.task_groups[0].count = count
            s.register_job(job)
            assert s.wait_for_evals(timeout=60)
        s.register_node(ref_mock.node())
        assert s.wait_for_evals(timeout=60)
    finally:
        s.shutdown()
    _WARM.append(True)


def wait_until(fn, timeout=10.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        v = fn()
        if v:
            return v
        time.sleep(0.02)
    raise AssertionError(f"timeout waiting for {msg}")


def restart_rpc(side, port):
    """A fresh RPC server on a port a stopped one held."""
    srv = side.RPCServer(port=port)
    deadline = time.monotonic() + 5
    while True:
        try:
            srv.start()
            return srv
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.05)


class KVStore:
    def __init__(self):
        self.kv = {}
        self.latest_index = 0


class KVFsm:
    """Tiny FSM target: applies SCHED_CONFIG payloads as kv sets, and
    keeps every applied row with its result."""

    def __init__(self):
        self.store = KVStore()
        self.applied = []

    def apply(self, index, mtype, payload):
        self.store.latest_index = index
        result = None
        if payload and "k" in payload:
            self.store.kv[payload["k"]] = payload["v"]
            result = ("set", payload["k"])
        self.applied.append((index, int(mtype), payload, result))
        return result

    def save(self, path):
        with open(path, "wb") as f:
            pickle.dump({"kv": self.store.kv, "index": self.store.latest_index}, f)
        return self.store.latest_index

    def load(self, path):
        with open(path, "rb") as f:
            data = pickle.load(f)
        self.store.kv = data["kv"]
        self.store.latest_index = data["index"]


class Cluster:
    def __init__(self, side, n, tmp_path=None, **cfg_over):
        self.side = side
        self.rpc = [side.RPCServer() for _ in range(n)]
        for r in self.rpc:
            r.start()
        self.ids = [f"s{i}" for i in range(n)]
        self.tmp_path = tmp_path
        peers = {self.ids[i]: self.rpc[i].address for i in range(n)}
        self.fsms = [KVFsm() for _ in range(n)]
        self.nodes = []
        for i in range(n):
            node = self.make_node(i, peers, self.fsms[i], **cfg_over)
            node.start(self.rpc[i])
            self.nodes.append(node)

    def make_node(self, i, peers, fsm, **cfg_over):
        cfg = self.side.RaftConfig(
            node_id=self.ids[i], peers=dict(peers),
            data_dir=str(self.tmp_path / self.ids[i]) if self.tmp_path else None,
            **{**FAST, **cfg_over}, **raft_rng(self.side, i),
        )
        return self.side.RaftNode(
            cfg, fsm, snapshot_fn=fsm.save, restore_fn=fsm.load,
        )

    def leader(self, timeout=5.0):
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            leaders = [n for n in self.nodes if n.is_leader()]
            if len(leaders) == 1:
                return leaders[0]
            time.sleep(0.02)
        raise AssertionError(
            f"no single leader: {[(n.config.node_id, n.state) for n in self.nodes]}"
        )

    def shutdown(self):
        for n in self.nodes:
            n.shutdown()
        for r in self.rpc:
            r.stop()


def rows(fsm):
    """The FSM's applied rows without the election barriers."""
    return [r for r in fsm.applied if r[1] != int(MsgType.NOOP)]


def same_log_within(fsms):
    """Every replica that applied an index applied the same row there."""
    by_index = {}
    for f in fsms:
        for row in f.applied:
            assert by_index.setdefault(row[0], row) == row, row


def same_log_across(ref_fsm, port_fsm, ordered=True):
    ref = [r[1:] for r in rows(ref_fsm)]
    port = [r[1:] for r in rows(port_fsm)]
    if ordered:
        assert port == ref
    else:
        assert sorted(port, key=repr) == sorted(ref, key=repr)
    assert port_fsm.store.kv == ref_fsm.store.kv


def put(node, side, k, v):
    return node.apply(side.MsgType.SCHED_CONFIG, {"k": k, "v": v})


# -- tests/test_raft.py ---------------------------------------------------------


def test_single_node_self_elects_and_applies():
    def run(side):
        c = Cluster(side, 1)
        try:
            index, result = put(c.leader(), side, "a", 1)
            assert result == ("set", "a")
            assert c.fsms[0].store.kv == {"a": 1}
            assert index >= 1
            return c.fsms[0]
        finally:
            c.shutdown()

    ref, port = both(run)
    same_log_across(ref, port)


def test_three_node_election_and_replication():
    def run(side):
        c = Cluster(side, 3)
        try:
            leader = c.leader()
            for i in range(5):
                put(leader, side, f"k{i}", i)
            expect = {f"k{i}": i for i in range(5)}
            wait_until(
                lambda: all(f.store.kv == expect for f in c.fsms),
                msg="replication to all followers",
            )
            assert sum(n.is_leader() for n in c.nodes) == 1
            same_log_within(c.fsms)
            return c.fsms[c.nodes.index(leader)]
        finally:
            c.shutdown()

    ref, port = both(run)
    same_log_across(ref, port)


def test_followers_reject_apply_with_leader_hint():
    def run(side):
        c = Cluster(side, 3)
        try:
            leader = c.leader()
            follower = next(n for n in c.nodes if n is not leader)
            # a follower names the leader once its first heartbeat lands
            wait_until(
                lambda: follower.leader_id() == leader.config.node_id,
                msg="follower hears the leader",
            )
            with pytest.raises(side.NotLeaderError) as e:
                put(follower, side, "x", 1)
            assert e.value.leader_id == leader.config.node_id
            assert e.value.leader_addr == leader.config.peers[leader.config.node_id]
            return type(e.value).__name__, str(e.value).split("=")[0]
        finally:
            c.shutdown()

    ref, port = both(run)
    assert port == ref


def test_leader_failover_and_rejoin_catchup():
    def run(side):
        c = Cluster(side, 3)
        try:
            leader = c.leader()
            put(leader, side, "before", 1)
            idx = c.nodes.index(leader)
            leader.shutdown()
            c.rpc[idx].stop()
            survivors = [n for n in c.nodes if n is not leader]
            wait_until(
                lambda: sum(n.is_leader() for n in survivors) == 1,
                timeout=10, msg="new leader elected",
            )
            new_leader = next(n for n in survivors if n.is_leader())
            assert new_leader.term > leader.term
            put(new_leader, side, "after", 2)
            other = next(n for n in survivors if n is not new_leader)
            wait_until(
                lambda: other.fsm.store.kv.get("after") == 2,
                msg="survivor caught up",
            )
            assert other.fsm.store.kv.get("before") == 1
            same_log_within([n.fsm for n in survivors])
            return other.fsm
        finally:
            c.shutdown()

    ref, port = both(run)
    same_log_across(ref, port)


def test_partitioned_follower_catches_up():
    def run(side):
        c = Cluster(side, 3)
        try:
            leader = c.leader()
            fidx = next(i for i, n in enumerate(c.nodes) if not n.is_leader())
            follower = c.nodes[fidx]
            c.rpc[fidx].stop()
            for i in range(10):
                put(leader, side, f"m{i}", i)
            srv = restart_rpc(side, c.rpc[fidx].port)
            srv.register("Raft.request_vote", follower._handle_request_vote)
            srv.register("Raft.append_entries", follower._handle_append_entries)
            srv.register("Raft.install_snapshot", follower._handle_install_snapshot)
            c.rpc[fidx] = srv
            wait_until(
                lambda: follower.fsm.store.kv.get("m9") == 9,
                msg="partitioned follower caught up",
            )
            same_log_within(c.fsms)
            return follower.fsm
        finally:
            c.shutdown()

    ref, port = both(run)
    same_log_across(ref, port)


def test_log_persists_across_restart(tmp_path):
    def run(side):
        base = tmp_path / side.name
        c = Cluster(side, 1, tmp_path=base)
        try:
            leader = c.leader()
            for i in range(20):
                put(leader, side, f"p{i}", i)
        finally:
            c.shutdown()
        before = c.fsms[0]
        rpc = side.RPCServer()
        rpc.start()
        fsm = KVFsm()
        cfg = side.RaftConfig(
            node_id="s0", peers={"s0": rpc.address},
            data_dir=str(base / "s0"), **FAST, **raft_rng(side, 9),
        )
        node = side.RaftNode(cfg, fsm, snapshot_fn=fsm.save, restore_fn=fsm.load)
        node.start(rpc)
        try:
            wait_until(node.is_leader, msg="re-election after restart")
            wait_until(lambda: fsm.store.kv.get("p19") == 19, msg="log replay restored state")
            assert {k: v for k, v in fsm.store.kv.items() if k.startswith("p")} == {
                f"p{i}": i for i in range(20)
            }
            # the replay re-applies the very rows, at the very indexes
            assert [r for r in rows(fsm)] == rows(before)
            return fsm
        finally:
            node.shutdown()
            rpc.stop()

    ref, port = both(run)
    same_log_across(ref, port)


def test_snapshot_compacts_and_installs_on_blank_follower(tmp_path):
    def run(side):
        base = tmp_path / side.name
        c = Cluster(side, 3, tmp_path=base, snapshot_threshold=10)
        try:
            leader = c.leader()
            for i in range(40):
                put(leader, side, f"s{i}", i)
            li = c.nodes.index(leader)
            wait_until(lambda: c.nodes[li].snap_index > 0, msg="leader snapshotted")
            fidx = next(i for i, n in enumerate(c.nodes) if not n.is_leader())
            c.nodes[fidx].shutdown()
            c.rpc[fidx].stop()
            shutil.rmtree(base / c.ids[fidx])
            srv = restart_rpc(side, c.rpc[fidx].port)
            c.rpc[fidx] = srv
            fsm = KVFsm()
            cfg = side.RaftConfig(
                node_id=c.ids[fidx],
                peers={c.ids[i]: c.rpc[i].address for i in range(3)},
                data_dir=str(base / c.ids[fidx]),
                snapshot_threshold=10, **FAST, **raft_rng(side, 10 + fidx),
            )
            node = side.RaftNode(cfg, fsm, snapshot_fn=fsm.save, restore_fn=fsm.load)
            node.start(srv)
            c.nodes[fidx] = node
            c.fsms[fidx] = fsm
            wait_until(
                lambda: fsm.store.kv.get("s39") == 39, timeout=10,
                msg="blank follower restored via snapshot+log",
            )
            assert fsm.store.kv.get("s0") == 0
            return c.fsms[li], fsm.store.kv
        finally:
            c.shutdown()

    (ref_leader, ref_kv), (port_leader, port_kv) = both(run)
    same_log_across(ref_leader, port_leader)
    assert port_kv == ref_kv


def test_concurrent_applies_all_commit():
    def run(side):
        c = Cluster(side, 3)
        try:
            leader = c.leader()
            errs = []

            def writer(n):
                try:
                    for i in range(10):
                        put(leader, side, f"w{n}-{i}", i)
                except Exception as e:  # noqa: BLE001
                    errs.append(e)

            ts = [threading.Thread(target=writer, args=(n,)) for n in range(4)]
            for t in ts:
                t.start()
            for t in ts:
                t.join(30)
            assert not errs
            keys = {f"w{n}-{i}" for n in range(4) for i in range(10)}
            wait_until(
                lambda: all(keys <= set(f.store.kv) for f in c.fsms),
                msg="all concurrent writes on all nodes",
            )
            same_log_within(c.fsms)
            return c.fsms[c.nodes.index(leader)]
        finally:
            c.shutdown()

    ref, port = both(run)
    same_log_across(ref, port, ordered=False)


# -- tests/test_autopilot.py: TestRaftPeerRemoval --------------------------------


def make_cluster(side, tmp_path, n=3, dead_after=1.0):
    """The reference's autopilot cluster: gossip on, no workers."""
    rpcs = [side.RPCServer() for _ in range(n)]
    for r in rpcs:
        r.start()
    peers = {f"s{i}": rpcs[i].address for i in range(n)}
    servers = []
    for i in range(n):
        cs = side.ClusterServer(
            f"s{i}", dict(peers), rpcs[i],
            data_dir=str(tmp_path / side.name / f"s{i}"),
            server_config=side.config(num_workers=0),
            gossip_seeds=[rpcs[0].address] if i else [],
            **CLUSTER_FAST, **raft_rng(side, i),
        )
        cs.dead_server_cleanup_after = dead_after
        cs.autopilot_interval = 0.2
        servers.append(cs)
    for s in servers:
        s.start()
    return rpcs, servers


def leader_of(servers, timeout=10.0, exclude=()):
    return wait_until(
        lambda: next(
            (s for s in servers if s not in exclude and s.raft.is_leader()), None
        ),
        timeout=timeout, msg="leader elected",
    )


def test_remove_peer_via_log(tmp_path):
    def run(side):
        rpcs, servers = make_cluster(side, tmp_path, n=3, dead_after=3600)
        try:
            leader = leader_of(servers)
            follower = next(s for s in servers if s is not leader)
            leader.raft.remove_peer(follower.node_id)
            survivors = [s for s in servers if s is not follower]
            for s in survivors:
                wait_until(
                    lambda s=s: follower.node_id not in s.raft.peers(),
                    msg=f"{s.node_id} drops {follower.node_id}",
                )
            wait_until(lambda: follower.raft._removed, msg="follower removed flag")
            leader.raft.barrier(timeout=5.0)
            # the removal is one committed entry in the leader's log
            removal = [
                payload for mtype, payload in _log_rows(leader.raft)
                if mtype == int(side.MsgType.RAFT_REMOVE_PEER)
            ]
            assert removal == [{"node_id": follower.node_id}]
            # which server leads and which is removed follows the
            # election: name them by role
            role = {leader.node_id: "leader", follower.node_id: "removed"}
            return {
                role.get(s.node_id, "survivor"): (
                    sorted(role.get(p, "survivor") for p in s.raft.peers()),
                    s.raft._removed,
                )
                for s in servers
            }
        finally:
            for s in servers:
                s.shutdown()
            for r in rpcs:
                r.stop()

    ref, port = both(run)
    assert port == ref
    assert port["leader"] == (["leader", "survivor"], False)


def _log_rows(raft):
    """(type, payload) of every entry in a node's log."""
    with raft._mu:
        first, last = raft.log.first_index(), raft.log.last_index()
        return [
            (mtype, pickle.loads(data))
            for _term, mtype, data in (
                raft.log.get(i) for i in range(max(first, 1), last + 1)
            )
        ]


def test_removal_survives_restart_without_blocking_joins(tmp_path):
    class _Store:
        latest_index = 0

        def bump_index(self, i):
            self.latest_index = max(self.latest_index, i)

    def run(side):
        base = tmp_path / side.name

        def mknode(node_id, peers, ddir):
            store = _Store()
            fsm = side.FSM(lambda: store)
            fsm.store.latest_index = 0
            return side.RaftNode(
                side.RaftConfig(node_id=node_id, peers=dict(peers), data_dir=str(ddir)),
                fsm,
            )

        seen = []
        peers = {"a": "addr-a", "b": "addr-b", "c": "addr-c"}
        n = mknode("a", peers, base / "a")
        n._apply_remove_peer_config("c", removal_index=7)
        assert "c" not in n.config.peers
        seen.append(sorted(n.config.peers))
        n.shutdown()
        n2 = mknode("a", peers, base / "a")
        assert "c" not in n2.config.peers
        seen.append(sorted(n2.config.peers))
        n2.shutdown()
        n3 = mknode("a", {**peers, "d": "addr-d"}, base / "a")
        assert "d" in n3.config.peers and "c" not in n3.config.peers
        seen.append(sorted(n3.config.peers))
        n3.shutdown()
        v = mknode("c", peers, base / "c")
        v._apply_remove_peer_config("c", removal_index=7)
        assert v._removed
        v.shutdown()
        v2 = mknode("c", peers, base / "c")
        assert v2._removed
        seen.append(sorted(v2.config.peers))
        v2.shutdown()
        return seen

    ref, port = both(run)
    assert port == ref


def test_removed_peer_set_is_read_through_the_allowlist(tmp_path):
    """The durable removed-peer set is loaded with ``restricted_loads``:
    a blob naming a callable is refused, not run (the reference reads it
    with bare ``pickle.loads``)."""
    from nomad_tpu_torch.native import WalStore
    from nomad_tpu_torch.rpc.framing import FramingError

    ddir = tmp_path / "evil"
    (ddir).mkdir()
    wal = WalStore(str(ddir / "raft"))
    wal.kv_set("removed_peers", pickle.dumps(print))
    wal.sync()
    wal.close()
    store = types.SimpleNamespace(latest_index=0)
    with pytest.raises(FramingError):
        RaftNode(
            RaftConfig(node_id="a", peers={"a": "addr-a"}, data_dir=str(ddir)),
            FSM(lambda: store),
        )


def test_remove_leader_rejected(tmp_path):
    def run(side):
        rpcs, servers = make_cluster(side, tmp_path, n=3, dead_after=3600)
        try:
            leader = leader_of(servers)
            msgs = []
            for target in (leader.node_id, "nonexistent"):
                with pytest.raises(ValueError) as e:
                    leader.raft.remove_peer(target)
                msgs.append(str(e.value).replace(leader.node_id, "<leader>"))
            assert len(leader.raft.peers()) == 3
            return msgs
        finally:
            for s in servers:
                s.shutdown()
            for r in rpcs:
                r.stop()

    ref, port = both(run)
    assert port == ref


def test_election_timeouts_follow_the_generator():
    """``RaftConfig.rng`` fixes the draws: one seed, one sequence; by
    default a generator seeded from the node id."""
    a = RaftConfig(node_id="x", peers={}, rng=random.Random(3))
    b = RaftConfig(node_id="x", peers={}, rng=random.Random(3))
    assert [a.rng.uniform(0, 1) for _ in range(5)] == [b.rng.uniform(0, 1) for _ in range(5)]
    c, d = RaftConfig(node_id="s1", peers={}), RaftConfig(node_id="s1", peers={})
    assert c.rng.random() == d.rng.random()
    assert RaftConfig(node_id="s2", peers={}).rng.random() != RaftConfig(
        node_id="s1", peers={}
    ).rng.random()
