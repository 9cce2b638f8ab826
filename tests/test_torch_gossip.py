"""The port's gossip membership and autopilot (``server/gossip.py``,
``ClusterServer.autopilot_sweep``) against the JAX package's, on the
CPU: the scenarios of ``tests/test_gossip.py`` and of
``tests/test_autopilot.py``'s ``TestSWIMIncarnationOwnership`` and
``TestAutopilot``, each run on both packages at once (``both`` from
``test_torch_raft.py``; fixed generators: the port's ``Gossip(rng=...)``
and ``RaftConfig.rng``, the reference's module-level ``random`` seeded).

What is compared: the member tables (names, statuses, incarnations) a
scenario ends with, the survivors' raft peer sets after autopilot's
cleanup (servers named by role: which one leads follows the election),
and, where a forwarded job schedules, its allocs by ``(job, node)``
counts and name sets (ROADMAP C-S1).

Tolerance: exact.
"""

import random
import time

from nomad_tpu import mock as ref_mock
from test_torch_cluster import alloc_view
from test_torch_raft import (
    CLUSTER_FAST,
    PORT,
    REF,
    both,
    fixed_generators,  # noqa: F401 — autouse fixture
    leader_of,
    make_cluster,
    wait_until,
    warm_reference,
)


def make_member(side, name, region="global", seeds=()):
    rpc = side.RPCServer()
    rpc.start()
    kw = {} if side is REF else {"rng": random.Random(f"t:{name}")}
    g = side.gossip.Gossip(
        name=name, addr=rpc.address, region=region, rpc_server=rpc,
        seeds=list(seeds), interval=0.1, **kw,
    )
    g.start()
    return rpc, g


def table(g):
    return sorted(
        (m.name, m.status, m.incarnation) for m in g.members_snapshot().values()
    )


# -- tests/test_gossip.py -------------------------------------------------------


def test_transitive_discovery():
    def run(side):
        rpc_a, a = make_member(side, "a")
        rpc_b, b = make_member(side, "b", seeds=[rpc_a.address])
        rpc_c, c = make_member(side, "c", seeds=[rpc_b.address])
        try:
            for g in (a, b, c):
                wait_until(
                    lambda g=g: {m.name for m in g.alive_members()} == {"a", "b", "c"},
                    timeout=15, msg=f"{g.name} full membership",
                )
            return [
                sorted((m.name, m.status) for m in g.alive_members()) for g in (a, b, c)
            ]
        finally:
            for g in (a, b, c):
                g.stop()
            for r in (rpc_a, rpc_b, rpc_c):
                r.stop()

    ref, port = both(run)
    assert port == ref


def test_failure_detection_and_refutation():
    def run(side):
        rpc_a, a = make_member(side, "a")
        rpc_b, b = make_member(side, "b", seeds=[rpc_a.address])
        try:
            wait_until(lambda: len(a.alive_members()) == 2, timeout=15, msg="a sees b")
            b.stop()
            rpc_b.stop()
            wait_until(
                lambda: any(
                    m.name == "b" and m.status == side.gossip.STATUS_FAILED
                    for m in a.members.values()
                ),
                timeout=30, msg="b declared failed",
            )
            inc = a.members["a"].incarnation
            a.merge([{
                "name": "a", "addr": a.addr, "region": "global",
                "status": side.gossip.STATUS_FAILED, "incarnation": inc,
                "last_seen": time.time(),
            }])
            me = a.members["a"]
            assert me.status == side.gossip.STATUS_ALIVE
            assert me.incarnation == inc + 1
            return me.status, a.members["b"].status, a.members["b"].failed_since > 0
        finally:
            a.stop()
            rpc_a.stop()

    ref, port = both(run)
    assert port == ref


def test_region_discovery_drives_forwarding(tmp_path):
    warm_reference()

    def run(side):
        rpcs = {r: side.RPCServer() for r in ("east", "west")}
        for r in rpcs.values():
            r.start()
        servers = {}
        for region in ("east", "west"):
            seeds = [rpcs["east"].address] if region == "west" else []
            servers[region] = side.ClusterServer(
                f"{region}-s0", {f"{region}-s0": rpcs[region].address},
                rpcs[region], data_dir=str(tmp_path / side.name / region),
                server_config=side.config(num_workers=1, region=region),
                gossip_seeds=seeds, **CLUSTER_FAST,
            )
        for s in servers.values():
            s.start()
        client = side.RPCClient(rpcs["east"].address)
        try:
            for s in servers.values():
                wait_until(lambda s=s: s.server._leader, msg="leader services")
            wait_until(
                lambda: "west" in servers["east"].gossip.region_peers(),
                timeout=15, msg="east discovers west via gossip",
            )
            servers["west"].server.store.upsert_node(
                2, side.node(ref_mock.node(id="west-node", name="west-node"))
            )
            job = ref_mock.job(region="west")
            job.id = job.name = "west-job"
            job.task_groups[0].count = 1
            job.task_groups[0].tasks[0].driver = "mock_driver"
            client.call("Nomad.register_job", {"job": side.job(job)})
            west = servers["west"].server.store
            wait_until(lambda: west.job_by_id("default", "west-job"), msg="job in west")
            wait_until(lambda: west.allocs_by_job("default", "west-job"), msg="west placement")
            assert servers["east"].server.store.job_by_id("default", "west-job") is None
            return alloc_view(west, "west-job")
        finally:
            client.close()
            for s in servers.values():
                s.shutdown()
            for r in rpcs.values():
                r.stop()

    ref, port = both(run)
    assert port == ref


# -- tests/test_autopilot.py: TestSWIMIncarnationOwnership ----------------------


def _lone(side):
    rpc = side.RPCServer()
    rpc.start()
    g = side.gossip.Gossip(
        name="a", addr=rpc.address, region="global", rpc_server=rpc,
        seeds=[], interval=0.1,
    )
    return rpc, g


def test_observer_never_bumps_remote_incarnation():
    def run(side):
        rpc, a = _lone(side)
        try:
            a.members["b"] = side.gossip.Member(
                name="b", addr="127.0.0.1:1", region="global",
                status=side.gossip.STATUS_SUSPECT, incarnation=7,
            )
            a._mark_alive("127.0.0.1:1")
            m = a.members["b"]
            assert m.status == side.gossip.STATUS_ALIVE
            assert m.incarnation == 7
            return table(a)
        finally:
            rpc.stop()

    ref, port = both(run)
    assert port == ref


def test_refutation_still_owns_incarnation():
    def run(side):
        rpc, a = _lone(side)
        try:
            inc0 = a.members["a"].incarnation
            a.merge([{
                "name": "a", "addr": a.addr, "region": "global",
                "status": side.gossip.STATUS_FAILED, "incarnation": inc0 + 3,
                "last_seen": time.time(),
            }])
            me = a.members["a"]
            assert me.status == side.gossip.STATUS_ALIVE
            assert me.incarnation == inc0 + 4
            return table(a)
        finally:
            rpc.stop()

    ref, port = both(run)
    assert port == ref


def test_partitioned_observers_converge_no_flapping():
    def run(side):
        rpc, a = _lone(side)
        try:
            a.members["c"] = side.gossip.Member(
                name="c", addr="127.0.0.1:2", region="global",
                status=side.gossip.STATUS_ALIVE, incarnation=5,
            )
            seen = []
            for i in range(20):
                status = side.gossip.STATUS_SUSPECT if i % 2 else side.gossip.STATUS_ALIVE
                a.merge([{
                    "name": "c", "addr": "127.0.0.1:2", "region": "global",
                    "status": status, "incarnation": 5, "last_seen": time.time(),
                }])
                seen.append(a.members["c"].status)
                a._mark_alive("127.0.0.1:2")
            assert a.members["c"].incarnation == 5
            assert a.members["c"].status == side.gossip.STATUS_ALIVE
            return seen, table(a)
        finally:
            rpc.stop()

    ref, port = both(run)
    assert port == ref


# -- tests/test_autopilot.py: TestAutopilot -------------------------------------


def _roles(servers, leader, gone):
    """Each server's raft peer set, servers named by role."""
    role = {leader.node_id: "leader"}
    for g in gone:
        role[g.node_id] = "dead"

    def name(x):
        return role.get(x, "survivor")

    return {
        name(s.node_id): sorted(name(p) for p in s.raft.peers())
        for s in servers if s not in gone
    }


def test_dead_server_cleanup(tmp_path):
    def run(side):
        rpcs, servers = make_cluster(side, tmp_path, n=3, dead_after=0.5)
        victim = None
        try:
            leader = leader_of(servers)
            wait_until(
                lambda: all(len(s.gossip.alive_members()) == 3 for s in servers),
                timeout=20, msg="full gossip membership",
            )
            victim = next(s for s in servers if not s.raft.is_leader())
            victim.shutdown()
            rpcs[servers.index(victim)].stop()
            wait_until(
                lambda: victim.node_id not in leader.raft.peers(),
                timeout=60, msg="autopilot removed the dead server",
            )
            cur = leader_of(servers, exclude=(victim,))
            cur.raft.barrier(timeout=5.0)
            alive = [s for s in servers if s is not victim]
            wait_until(
                lambda: all(victim.node_id not in s.raft.peers() for s in alive),
                msg="every survivor drops the dead server",
            )
            return _roles(servers, cur, [victim])
        finally:
            for s in servers:
                if s is not victim:
                    s.shutdown()
            for r in rpcs:
                r.stop()

    ref, port = both(run)
    assert port == ref == {"leader": ["leader", "survivor"], "survivor": ["leader", "survivor"]}


def test_quorum_guard_blocks_unsafe_cleanup(tmp_path):
    def run(side):
        rpcs, servers = make_cluster(side, tmp_path, n=3, dead_after=0.3)
        leader = None
        try:
            leader = leader_of(servers)
            wait_until(
                lambda: all(len(s.gossip.alive_members()) == 3 for s in servers),
                timeout=20, msg="full gossip membership",
            )
            victims = [s for s in servers if s is not leader]
            for v in victims:
                v.shutdown()
                rpcs[servers.index(v)].stop()
            wait_until(
                lambda: sum(
                    1 for m in leader.gossip.members_snapshot().values()
                    if m.status == side.gossip.STATUS_FAILED
                ) == 2,
                timeout=60, msg="leader sees both victims failed",
            )
            time.sleep(1.5)  # several sweeps past the cleanup deadline
            assert len(leader.raft.peers()) == 3
            assert leader.autopilot_sweep() == []
            return _roles(servers, leader, victims)
        finally:
            if leader is not None:
                leader.shutdown()
            for r in rpcs:
                r.stop()

    ref, port = both(run)
    assert port == ref == {"leader": ["dead", "dead", "leader"]}


def test_sync_target_follows_the_generator():
    """``Gossip(rng=...)`` fixes which target a sync round picks."""
    picks = []
    for _ in range(2):
        rpc = PORT.RPCServer()
        rpc.start()
        try:
            g = PORT.gossip.Gossip(
                name="a", addr=rpc.address, region="global", rpc_server=rpc,
                seeds=[f"127.0.0.1:{p}" for p in (1, 2, 3, 4)], rng=random.Random(5),
            )
            picks.append([g._rng.choice(g._targets()) for _ in range(8)])
        finally:
            rpc.stop()
    assert picks[0] == picks[1]
