"""The port's server cluster (``server/cluster.py``: ``ClusterServer``,
``RemoteClientRPC``, ``Server.attach_raft``) against the JAX package's,
on the CPU: the scenarios of ``tests/test_cluster.py`` and
``tests/test_federation.py``, each run on one package, then the other
(``in_turn`` from ``test_torch_raft.py``; the port's servers on ``device="cpu"``, the
reference's under the scoped ``reference_runtime``, ROADMAP C-R1).

Both sides get the same nodes and jobs (the reference's mock objects,
carried into the port through ``interop.from_record``, so ids match).
What is compared: the replicated allocs by ``(job, node)`` counts and
name sets (ROADMAP C-S1), on every server of a side and across the two
sides; the state a restarted server recovers; the TTL a forwarded
heartbeat returns. A real client agent (each package's own) runs the
allocs over ``RemoteClientRPC``; its node id is its own, so that
scenario compares counts and names by job.

Every wait has its own deadline; every cluster stops in ``finally``.

Tolerance: exact.
"""

import contextlib
import json
import urllib.error
import urllib.request

import pytest

from nomad_tpu import mock as ref_mock
from test_torch_raft import (
    CLUSTER_FAST,
    fixed_generators,  # noqa: F401 — autouse fixture
    in_turn,
    leader_of,
    wait_until,
    warm_reference,
)

WAIT_S = 20.0


@pytest.fixture(autouse=True)
def _warm(fixed_generators):  # noqa: F811 — after the reference runtime is up
    warm_reference()


def node(i):
    return ref_mock.node(id=f"cluster-node-{i}", name=f"cluster-node-{i}")


def job(name, count=None, region=None, driver=None, config=None):
    j = ref_mock.job(region=region) if region else ref_mock.job()
    j.id = j.name = name
    if count is not None:
        j.task_groups[0].count = count
    for t in j.task_groups[0].tasks:
        if driver:
            t.driver = driver
        if config:
            t.config = dict(config)
    return j


def alloc_view(store, job_id, by_node=True):
    """(job, node) counts (or the count by job) and the name set of a
    job's live allocs."""
    live = [a for a in store.allocs_by_job("default", job_id) if not a.terminal_status()]
    counts = {}
    for a in live:
        key = (a.job_id, a.node_id) if by_node else a.job_id
        counts[key] = counts.get(key, 0) + 1
    return counts, sorted(a.name for a in live)


def same_everywhere(servers, job_id, by_node=True):
    views = [alloc_view(s.server.store, job_id, by_node) for s in servers]
    assert all(v == views[0] for v in views), views
    return views[0]


@contextlib.contextmanager
def cluster3(side, tmp_path, ids=("s0", "s1", "s2"), **cfg):
    rpcs = [side.RPCServer() for _ in range(3)]
    for r in rpcs:
        r.start()
    peers = {ids[i]: rpcs[i].address for i in range(3)}
    servers = [
        side.ClusterServer(
            ids[i], peers, rpcs[i], data_dir=str(tmp_path / side.name / ids[i]),
            server_config=side.config(**cfg), **CLUSTER_FAST,
        )
        for i in range(3)
    ]
    try:
        for s in servers:
            s.start()
        yield servers
    finally:
        for s in servers:
            s.shutdown()
        for r in rpcs:
            r.stop()


def services_up(servers, exclude=()):
    leader = leader_of(servers, exclude=exclude)
    wait_until(lambda: leader.server._leader, msg="leader services up")
    return leader


# -- tests/test_cluster.py: TestCluster -----------------------------------------


def test_schedule_through_follower_replicates_everywhere(tmp_path):
    def run(side):
        with cluster3(side, tmp_path, num_workers=1, heartbeat_ttl=2.0) as cluster:
            leader = services_up(cluster)
            follower = next(s for s in cluster if s is not leader)
            c = side.RPCClient(follower.rpc.address)
            try:
                c.call("Nomad.register_node", {"node": side.node(node(0))})
                j = job("through-follower")
                c.call("Nomad.register_job", {"job": side.job(j)})
                wait_until(
                    lambda: any(
                        e.status == "blocked"
                        for e in leader.server.store.evals_by_job("default", j.id)
                    ),
                    timeout=WAIT_S, msg="blocked eval for the unplaceable remainder",
                )
                partial = alloc_view(leader.server.store, j.id)
                assert 0 < sum(partial[0].values()) < j.task_groups[0].count
                c.call("Nomad.register_node", {"node": side.node(node(1))})
                want = j.task_groups[0].count
                wait_until(
                    lambda: all(
                        len(s.server.store.allocs_by_job("default", j.id)) == want
                        for s in cluster
                    ),
                    timeout=WAIT_S, msg="allocs replicated to all servers",
                )
                evs = leader.server.store.evals_by_job("default", j.id)
                assert any(e.status == "complete" for e in evs)
                return partial, same_everywhere(cluster, j.id)
            finally:
                c.close()

    ref, port = in_turn(run)
    assert port == ref


def test_client_agent_over_tcp_runs_allocs(tmp_path):
    def run(side):
        with cluster3(side, tmp_path, num_workers=1, heartbeat_ttl=2.0) as cluster:
            leader = services_up(cluster)
            rpc = side.RemoteClientRPC([s.rpc.address for s in cluster])
            client = side.Client(
                rpc, data_dir=str(tmp_path / side.name / "client"),
                heartbeat_interval=0.2,
            )
            client.start()
            try:
                j = job("over-tcp", driver="mock_driver", config={"run_for": 10.0})
                leader.server.register_job(side.job(j))

                def running(s):
                    return any(
                        a.client_status == "running"
                        for a in s.server.store.allocs_by_job("default", j.id)
                    )

                wait_until(lambda: running(leader), timeout=WAIT_S,
                           msg="alloc running on remote client")
                f = next(s for s in cluster if s is not leader)
                wait_until(lambda: running(f), timeout=WAIT_S,
                           msg="running status replicated")
                return alloc_view(leader.server.store, j.id, by_node=False)
            finally:
                client.shutdown()
                rpc.close()

    ref, port = in_turn(run)
    assert port == ref


def test_leader_failover_keeps_scheduling(tmp_path):
    def run(side):
        with cluster3(side, tmp_path, num_workers=1, heartbeat_ttl=2.0) as cluster:
            leader = services_up(cluster)
            n = node(0)
            leader.server.register_node(side.node(n))
            j1 = job("before-failover", count=2)
            leader.server.register_job(side.job(j1))
            wait_until(
                lambda: leader.server.store.allocs_by_job("default", j1.id),
                timeout=WAIT_S, msg="first job placed",
            )
            dead_rpc = leader.rpc
            leader.shutdown()
            dead_rpc.stop()
            survivors = [s for s in cluster if s is not leader]
            new_leader = services_up(survivors)
            assert new_leader.server.store.node_by_id(n.id) is not None
            assert new_leader.server.store.allocs_by_job("default", j1.id)
            j2 = job("after-failover", count=2)
            new_leader.server.register_job(side.job(j2))
            wait_until(
                lambda: new_leader.server.store.allocs_by_job("default", j2.id),
                timeout=WAIT_S, msg="post-failover job placed",
            )
            wait_until(
                lambda: all(
                    len(s.server.store.allocs_by_job("default", j2.id)) == 2
                    for s in survivors
                ),
                timeout=WAIT_S, msg="post-failover allocs replicated",
            )
            return same_everywhere(survivors, j1.id), same_everywhere(survivors, j2.id)

    ref, port = in_turn(run)
    assert port == ref


# -- tests/test_cluster.py: TestDurableSingleServer ------------------------------


def test_restart_recovers_full_state(tmp_path):
    def run(side):
        datadir = str(tmp_path / side.name / "server")
        srv = side.Server(side.config(num_workers=1, data_dir=datadir))
        srv.establish_leadership()
        n, j = node(0), job("durable", count=3)
        try:
            srv.register_node(side.node(n))
            srv.register_job(side.job(j))
            wait_until(
                lambda: len(srv.store.allocs_by_job("default", j.id)) == 3,
                timeout=WAIT_S, msg="initial placement",
            )
            wait_until(
                lambda: all(
                    e.status in ("complete", "failed", "canceled")
                    for e in srv.store.evals_by_job("default", j.id)
                ),
                timeout=WAIT_S, msg="eval completion committed",
            )
            pre_allocs = {a.id for a in srv.store.allocs_by_job("default", j.id)}
            pre_view = alloc_view(srv.store, j.id)
            pre_index = srv.store.latest_index
        finally:
            srv.shutdown()
            srv.raft.close()
        srv2 = side.Server(side.config(num_workers=1, data_dir=datadir))
        try:
            assert srv2.store.latest_index == pre_index
            assert srv2.store.node_by_id(n.id) is not None
            assert {a.id for a in srv2.store.allocs_by_job("default", j.id)} == pre_allocs
            got = srv2.store.job_by_id("default", j.id)
            assert got is not None and got.task_groups[0].count == 3
            srv2.establish_leadership()
            j2 = job("durable-after", count=2)
            srv2.register_job(side.job(j2))
            wait_until(
                lambda: len(srv2.store.allocs_by_job("default", j2.id)) == 2,
                timeout=WAIT_S, msg="post-restart placement",
            )
            return pre_view, pre_index, alloc_view(srv2.store, j2.id)
        finally:
            srv2.shutdown()
            srv2.raft.close()

    ref, port = in_turn(run)
    assert port == ref


def test_snapshot_compaction_then_restart(tmp_path):
    def run(side):
        datadir = str(tmp_path / side.name / "server")
        srv = side.Server(side.config(num_workers=0, data_dir=datadir))
        try:
            for i in range(50):
                srv.register_node(side.node(node(i)))
            srv.raft.snapshot()
            for i in range(50, 60):
                srv.register_node(side.node(node(i)))
            n_nodes = len(list(srv.store.nodes()))
            idx = srv.store.latest_index
        finally:
            srv.raft.close()
        srv2 = side.Server(side.config(num_workers=0, data_dir=datadir))
        try:
            assert len(list(srv2.store.nodes())) == n_nodes
            assert srv2.store.latest_index == idx
            return n_nodes, idx, sorted(x.id for x in srv2.store.nodes())
        finally:
            srv2.raft.close()

    ref, port = in_turn(run)
    assert port == ref


# -- tests/test_cluster.py: TestHeartbeatForwarding -----------------------------


def test_follower_heartbeats_reach_leader_timers(tmp_path):
    def run(side):
        with cluster3(side, tmp_path, num_workers=0, heartbeat_ttl=2.0) as servers:
            leader = services_up(servers)
            follower = next(s for s in servers if s is not leader)
            n = node(0)
            leader.server.register_node(side.node(n))
            c = side.RPCClient(follower.rpc.address)
            try:
                ttl = c.call("Nomad.heartbeat", {"node_id": n.id})
                assert ttl == 2.0
                assert n.id in leader.server.heartbeater._deadlines
                return ttl
            finally:
                c.close()

    ref, port = in_turn(run)
    assert port == ref


# -- the HTTP API's operator raft endpoints on a real peer set -------------------


_LOCAL = urllib.request.build_opener(urllib.request.ProxyHandler({}))


def _http(agent, method, path):
    """One request to a local HTTP agent (``agent.address`` is
    ``http://127.0.0.1:<port>``)."""
    assert agent.address.startswith("http://127.0.0.1:"), agent.address
    req = urllib.request.Request(f"{agent.address}{path}", method=method)
    try:
        with _LOCAL.open(req, timeout=10) as resp:
            return resp.status, json.loads(resp.read() or b"null")
    except urllib.error.HTTPError as e:
        return e.code, e.read().decode(errors="replace")


def operator_raft(side, tmp_path, ids):
    """``GET /v1/operator/raft/configuration`` on the leader, ``DELETE
    /v1/operator/raft/peer`` of the third server on a follower then on
    the leader, the configuration again on the follower; servers named by
    role."""
    with cluster3(side, tmp_path, ids=ids, num_workers=0, heartbeat_ttl=2.0) as servers:
        leader = services_up(servers)
        follower, other = [s for s in servers if s is not leader]
        wait_until(
            lambda: follower.raft.leader_id() == leader.node_id, msg="follower hears leader"
        )
        agents = {s.node_id: side.HTTPAgent(s.server, None, port=0) for s in servers}
        for a in agents.values():
            a.start()
        try:
            role = {leader.node_id: "leader", follower.node_id: "follower",
                    other.node_id: "other"}
            code, conf = _http(agents[leader.node_id], "GET", "/v1/operator/raft/configuration")
            before = sorted((role[x["id"]], x["leader"], x["voter"]) for x in conf["servers"])
            refused = _http(
                agents[follower.node_id], "DELETE", f"/v1/operator/raft/peer?id={other.node_id}"
            )[0]
            code2, body = _http(
                agents[leader.node_id], "DELETE", f"/v1/operator/raft/peer?id={other.node_id}"
            )
            wait_until(
                lambda: other.node_id not in follower.raft.peers(), msg="removal replicated"
            )
            _, conf2 = _http(agents[follower.node_id], "GET", "/v1/operator/raft/configuration")
            after = sorted((role[x["id"]], x["leader"]) for x in conf2["servers"])
            return code, before, refused, code2, role[body["removed"]], after
        finally:
            for a in agents.values():
                a.stop()


def test_operator_raft_endpoints_over_a_real_peer_set(tmp_path):
    """The configuration lists the three voters with the leader marked; a
    removal answers 421 on a follower and commits through the log on the
    leader (the API's code reads the cluster's raft, swapped in by
    ``attach_raft``). One-character server ids: the JAX package's
    endpoint reads only an id's first character (ROADMAP C-R10)."""
    ref, port = in_turn(operator_raft, tmp_path, ("a", "b", "c"))
    assert port == ref
    assert port[1] == [("follower", False, True), ("leader", True, True), ("other", False, True)]
    assert port[2] == 421 and port[3] == 200 and port[4] == "other"
    assert port[5] == [("follower", False), ("leader", True)]


def test_raft_peer_endpoint_reads_the_whole_id(tmp_path):
    """The port's endpoint removes a server whose id is longer than one
    character (the JAX package's answers 400 for "unknown raft peer 's'")."""
    from test_torch_raft import PORT

    code, before, refused, code2, removed, after = operator_raft(PORT, tmp_path, ("s0", "s1", "s2"))
    assert (code, refused, code2, removed) == (200, 421, 200, "other")
    assert after == [("follower", False), ("leader", True)]


# -- tests/test_federation.py ---------------------------------------------------


@contextlib.contextmanager
def two_regions(side, tmp_path):
    rpcs = {r: side.RPCServer() for r in ("east", "west")}
    for r in rpcs.values():
        r.start()
    region_peers = {"east": [rpcs["east"].address], "west": [rpcs["west"].address]}
    servers = {}
    try:
        for region in ("east", "west"):
            servers[region] = side.ClusterServer(
                f"{region}-s0", {f"{region}-s0": rpcs[region].address},
                rpcs[region], data_dir=str(tmp_path / side.name / region),
                server_config=side.config(num_workers=1, region=region, heartbeat_ttl=2.0),
                region_peers={k: v for k, v in region_peers.items() if k != region},
                **CLUSTER_FAST,
            )
        for s in servers.values():
            s.start()
        for s in servers.values():
            wait_until(lambda s=s: s.raft.is_leader(), msg="leader election")
            wait_until(lambda s=s: s.server._leader, msg="leader services up")
        yield servers, rpcs
    finally:
        for s in servers.values():
            s.shutdown()
        for r in rpcs.values():
            r.stop()


def test_job_routed_to_its_region(tmp_path):
    def run(side):
        with two_regions(side, tmp_path) as (servers, rpcs):
            servers["west"].server.store.upsert_node(2, side.node(node(0)))
            client = side.RPCClient(rpcs["east"].address)
            try:
                j = job("routed-west", count=1, region="west", driver="mock_driver")
                client.call("Nomad.register_job", {"job": side.job(j)})
                west = servers["west"].server.store
                wait_until(lambda: west.job_by_id("default", j.id), msg="job in west")
                assert servers["east"].server.store.job_by_id("default", j.id) is None
                wait_until(lambda: west.allocs_by_job("default", j.id), msg="west placement")
                return alloc_view(west, j.id)
            finally:
                client.close()

    ref, port = in_turn(run)
    assert port == ref


def test_explicit_region_tag_forwards_any_write(tmp_path):
    def run(side):
        with two_regions(side, tmp_path) as (servers, rpcs):
            client = side.RPCClient(rpcs["east"].address)
            try:
                n = node(0)
                client.call("Nomad.register_node", {"node": side.node(n), "region": "west"})
                wait_until(
                    lambda: servers["west"].server.store.node_by_id(n.id), msg="node in west"
                )
                assert servers["east"].server.store.node_by_id(n.id) is None
                return servers["west"].server.store.node_by_id(n.id).id
            finally:
                client.close()

    ref, port = in_turn(run)
    assert port == ref


def test_unknown_region_is_an_error(tmp_path):
    def run(side):
        with two_regions(side, tmp_path) as (_servers, rpcs):
            client = side.RPCClient(rpcs["east"].address)
            try:
                try:
                    client.call(
                        "Nomad.register_node", {"node": side.node(node(0)), "region": "mars"}
                    )
                except Exception as e:  # noqa: BLE001 — the error crosses the wire
                    return "no path to region 'mars'" in str(e)
                return "no error"
            finally:
                client.close()

    ref, port = in_turn(run)
    assert port == ref is True


def test_local_region_jobs_stay_local(tmp_path):
    def run(side):
        with two_regions(side, tmp_path) as (servers, rpcs):
            servers["east"].server.store.upsert_node(2, side.node(node(0)))
            client = side.RPCClient(rpcs["east"].address)
            try:
                j = job("stays-east", region="east", driver="mock_driver")
                client.call("Nomad.register_job", {"job": side.job(j)})
                east = servers["east"].server.store
                wait_until(lambda: east.job_by_id("default", j.id), msg="job in east")
                assert servers["west"].server.store.job_by_id("default", j.id) is None
                return east.job_by_id("default", j.id).region
            finally:
                client.close()

    ref, port = in_turn(run)
    assert port == ref == "east"
