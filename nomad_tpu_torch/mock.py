"""Canonical fake objects for tests and benchmarks.

Reference: nomad/mock/mock.go (mock.Node, mock.Job, mock.Alloc,
mock.SystemJob, mock.Eval — 1,909 LoC of fixture factories that every
reference test builds on). Shapes are chosen to match the reference
fixtures' resource footprints so parity tests are comparable.
"""

from __future__ import annotations

import itertools
import uuid

from .structs import (
    Allocation,
    ComparableResources,
    Evaluation,
    Job,
    JOB_TYPE_BATCH,
    JOB_TYPE_SERVICE,
    JOB_TYPE_SYSTEM,
    NODE_STATUS_READY,
    Node,
    NodeResources,
    NodeReservedResources,
    Resources,
    Task,
    TaskGroup,
)

_counter = itertools.count()


def short_id(prefix: str) -> str:
    return f"{prefix}-{next(_counter):06d}-{uuid.uuid4().hex[:8]}"


def node(**overrides) -> Node:
    """mock.Node (mock.go:23-90): 4 GHz CPU, 8 GiB RAM, linux, dc1."""
    n = Node(
        id=str(uuid.uuid4()),
        name=short_id("node"),
        datacenter="dc1",
        node_class="",
        attributes={
            "kernel.name": "linux",
            "arch": "x86",
            "cpu.frequency": "2000",
            "cpu.numcores": "2",
            "driver.exec": "1",
            "driver.mock_driver": "1",
            "nomad.version": "1.2.3",
        },
        drivers={"exec": True, "mock_driver": True},
        node_resources=NodeResources(cpu=4000, memory_mb=8192, disk_mb=100 * 1024),
        reserved=NodeReservedResources(cpu=100, memory_mb=256, disk_mb=4 * 1024),
        status=NODE_STATUS_READY,
    )
    for k, v in overrides.items():
        setattr(n, k, v)
    n.compute_class()
    return n


def job(**overrides) -> Job:
    """mock.Job (mock.go:500-600): 1 service group × 10 allocs of
    web tasks at 500 MHz / 256 MiB."""
    j = Job(
        id=short_id("job"),
        name="my-job",
        type=JOB_TYPE_SERVICE,
        priority=50,
        datacenters=["dc1"],
        task_groups=[
            TaskGroup(
                name="web",
                count=10,
                tasks=[
                    Task(
                        name="web",
                        driver="exec",
                        resources=Resources(cpu=500, memory_mb=256),
                    )
                ],
            )
        ],
        status="pending",
        version=0,
    )
    for k, v in overrides.items():
        setattr(j, k, v)
    return j


def batch_job(**overrides) -> Job:
    j = job(type=JOB_TYPE_BATCH, name="batch-job", **overrides)
    j.task_groups[0].name = "worker"
    j.task_groups[0].tasks[0].name = "worker"
    return j


def system_job(**overrides) -> Job:
    """mock.SystemJob: runs on every feasible node."""
    j = Job(
        id=short_id("sysjob"),
        name="my-sysjob",
        type=JOB_TYPE_SYSTEM,
        priority=100,
        datacenters=["dc1"],
        task_groups=[
            TaskGroup(
                name="sys",
                count=1,
                tasks=[
                    Task(
                        name="sys",
                        driver="exec",
                        resources=Resources(cpu=100, memory_mb=64),
                    )
                ],
            )
        ],
    )
    for k, v in overrides.items():
        setattr(j, k, v)
    return j


def eval_for(j: Job, **overrides) -> Evaluation:
    e = Evaluation(
        namespace=j.namespace,
        priority=j.priority,
        type=j.type,
        job_id=j.id,
        triggered_by="job-register",
    )
    for k, v in overrides.items():
        setattr(e, k, v)
    return e


def alloc(j: Job | None = None, n: Node | None = None, **overrides) -> Allocation:
    """mock.Alloc: a placed instance of job's first group."""
    j = j or job()
    tg = j.task_groups[0]
    ask = tg.combined_resources()
    a = Allocation(
        id=str(uuid.uuid4()),
        namespace=j.namespace,
        name=f"{j.id}.{tg.name}[0]",
        job_id=j.id,
        job=j,
        job_version=j.version,
        task_group=tg.name,
        node_id=n.id if n else str(uuid.uuid4()),
        resources=ComparableResources(
            cpu=ask.cpu,
            memory_mb=ask.memory_mb,
            disk_mb=ask.disk_mb,
            bandwidth_mbits=ask.bandwidth_mbits(),
        ),
        desired_status="run",
        client_status="running",
    )
    for k, v in overrides.items():
        setattr(a, k, v)
    return a
