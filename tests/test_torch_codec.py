"""The port's JSON codec (``nomad_tpu_torch.api.codec``) against the JAX
package's, on the CPU.

Every struct kind the reference's mocks make, built by one recipe on each
package's own classes with the same ids: jobs with spreads, affinities,
constraints, volumes and volume mounts, services and checks, scaling,
gangs and throughputs, periodic and parameterized jobs, system jobs;
nodes with devices, host volumes, CSI plugins and topology; allocs with
metrics, score metadata, devices and a deployment status; evals with
failed-group metrics; deployments. Then:

- the port's ``encode`` of its objects equals the reference's of its own;
- crossed both ways, the JSON each package writes decodes in the other
  (``decode_job``, ``decode_node``, ``decode_alloc`` and the HTTP layer's
  ``_decode_into`` for evals and deployments) and encodes back to the
  same JSON.

The port's decoder also makes a task's ``log_config`` a ``LogConfig``
where the reference's leaves a dict (ROADMAP C-R7); that is checked on
the port alone, and it does not change the JSON. No tolerance applies:
JSON compares exactly.
"""

import importlib
import json
import types

import pytest

PACKAGES = ("nomad_tpu", "nomad_tpu_torch")


def _pkg(root):
    return types.SimpleNamespace(
        mock=importlib.import_module(f"{root}.mock"),
        structs=importlib.import_module(f"{root}.structs"),
        job=importlib.import_module(f"{root}.structs.job"),
        deployment=importlib.import_module(f"{root}.structs.deployment"),
        resources=importlib.import_module(f"{root}.structs.resources"),
        codec=importlib.import_module(f"{root}.api.codec"),
    )


REF, PORT = (_pkg(root) for root in PACKAGES)


def _job(P, job_id, **over):
    j = P.mock.job(id=job_id, **over)
    j.task_groups[0].tasks[0].config = {"command": "/bin/web", "args": ["-p", "80"]}
    return j


def job_spread_affinity(P):
    S = P.structs
    j = _job(P, "job-spread")
    j.constraints = [S.Constraint("${attr.kernel.name}", "linux", "=")]
    tg = j.task_groups[0]
    tg.spreads = [S.Spread("${node.datacenter}", 50,
                           [S.SpreadTarget("dc1", 70), S.SpreadTarget("dc2", 30)])]
    tg.affinities = [S.Affinity("${attr.storage.type}", "ssd", "=", 75)]
    tg.constraints = [S.Constraint(operand="distinct_hosts", r_target="true")]
    return j


def job_volumes_services(P):
    S = P.structs
    j = _job(P, "job-volumes")
    tg = j.task_groups[0]
    tg.volumes = {
        "data": S.VolumeRequest(name="data", type="host", source="certs", read_only=True),
        "db": S.VolumeRequest(name="db", type="csi", source="vol-1",
                              access_mode="single-node-writer",
                              attachment_mode="file-system", per_alloc=True),
    }
    task = tg.tasks[0]
    task.volume_mounts = [S.VolumeMount(volume="data", destination="/etc/ssl")]
    task.services = [S.Service(name="web", checks=[
        S.ServiceCheck(type="tcp", port=8080, interval_s=1.0, timeout_s=0.5),
        S.ServiceCheck(type="http", port=8080, path="/health")])]
    task.resources.devices = [S.RequestedDevice(name="nvidia/gpu", count=2, constraints=[
        S.Constraint("${device.attr.memory}", "8 GiB", ">=")])]
    task.log_config = P.job.LogConfig(max_files=3, max_file_size_mb=5)
    return j


def job_scaling(P):
    j = _job(P, "job-scaling")
    j.task_groups[0].scaling = P.job.ScalingPolicy(min=1, max=20, policy={"cooldown": "1m"})
    return j


def job_gang_throughput(P):
    j = _job(P, "job-gang")
    second = P.mock.job().task_groups[0]
    second.name = "ps"
    j.task_groups.append(second)
    j.gang = {"groups": ["web", "ps"], "colocate": "rack"}
    j.throughputs = {"tpu-v5e": 2.5, "nvidia-h100-80gb-hbm3": 4.0}
    return j


def job_periodic_parameterized(P):
    S = P.structs
    j = P.mock.batch_job(id="job-cron")
    j.periodic = S.PeriodicConfig(spec="*/15 * * * *", prohibit_overlap=True)
    p = P.mock.batch_job(id="job-param")
    p.parameterized = S.ParameterizedJobConfig(payload="required", meta_required=["input"])
    return [j, p, P.mock.system_job(id="job-system")]


def node_full(P):
    S = P.structs
    n = P.mock.node(id="node-0001", name="node-0001")
    n.node_resources.devices = [S.NodeDeviceResource(
        vendor="nvidia", type="gpu", name="h100",
        instances=[S.NodeDeviceInstance(id="GPU-0"), S.NodeDeviceInstance(id="GPU-1",
                                                                            healthy=False)],
        attributes={"memory": "80 GiB"})]
    n.host_volumes = {"certs": S.ClientHostVolumeConfig(name="certs", path="/etc/ssl")}
    n.csi_node_plugins = {"ebs": S.CSINodeInfo(plugin_id="ebs", healthy=True)}
    n.topology = {"rack": "r01", "pod": "p0", "ici": "0.1"}
    n.device_class = "nvidia-h100-80gb-hbm3"
    n.compute_class()
    return n


def alloc_full(P):
    S = P.structs
    j = job_spread_affinity(P)
    a = P.mock.alloc(j, node_full(P), id="alloc-0001", eval_id="eval-0001")
    a.metrics = S.AllocMetric(
        nodes_evaluated=3, nodes_filtered=1, nodes_available={"dc1": 3},
        constraint_filtered={"missing drivers": 1}, scores={"node-0001.binpack": 0.75},
        score_meta=[S.NodeScoreMeta(node_id="node-0001", scores={"binpack": 0.75},
                                    norm_score=0.75)],
        allocation_time_ns=1200,
    )
    a.allocated_devices = [P.resources.AllocatedDeviceResource(
        vendor="nvidia", type="gpu", name="h100", device_ids=["GPU-0"])]
    a.deployment_id = "dep-0001"
    a.deployment_status = P.deployment.AllocDeploymentStatus(healthy=True, canary=True)
    a.task_states = {"web": {"state": "running", "failed": False, "restarts": 1}}
    return a


def eval_failed(P):
    S = P.structs
    e = P.mock.eval_for(job_scaling(P), id="eval-0002")
    e.status = "blocked"
    e.failed_tg_allocs = {"web": S.AllocMetric(
        nodes_evaluated=4, nodes_exhausted=4, dimension_exhausted={"cpu": 4},
        coalesced_failures=9, rejections={"cpu": 4})}
    return e


def deployment_full(P):
    D = P.deployment
    return D.Deployment(
        id="dep-0001", job_id="job-spread", job_version=2,
        task_groups={"web": D.DeploymentState(
            auto_revert=True, desired_canaries=1, desired_total=10,
            placed_canaries=["alloc-0001"], healthy_allocs=1)},
    )


RECIPES = {
    "job_spread_affinity": (job_spread_affinity, "decode_job"),
    "job_volumes_services": (job_volumes_services, "decode_job"),
    "job_scaling": (job_scaling, "decode_job"),
    "job_gang_throughput": (job_gang_throughput, "decode_job"),
    "job_periodic_parameterized": (job_periodic_parameterized, "decode_job"),
    "node": (node_full, "decode_node"),
    "alloc": (alloc_full, "decode_alloc"),
    "eval": (eval_failed, "Evaluation"),
    "deployment": (deployment_full, "Deployment"),
}


def _as_list(x):
    return x if isinstance(x, list) else [x]


def _json(P, objs):
    """Each object's encoding, as the wire carries it."""
    return [json.loads(json.dumps(P.codec.encode(o))) for o in objs]


def _decode(P, how, data):
    if how.startswith("decode_"):
        return getattr(P.codec, how)(data)
    cls = getattr(P.structs, how) if hasattr(P.structs, how) else getattr(P.deployment, how)
    return P.codec._decode_into(cls, data)


@pytest.mark.parametrize("kind", sorted(RECIPES))
def test_encode_equals_reference(kind):
    build, _ = RECIPES[kind]
    ref = _json(REF, _as_list(build(REF)))
    port = _json(PORT, _as_list(build(PORT)))
    assert port == ref


@pytest.mark.parametrize("kind", sorted(RECIPES))
@pytest.mark.parametrize("direction", ["reference_to_port", "port_to_reference"])
def test_crossed_json_round_trips(kind, direction):
    build, how = RECIPES[kind]
    src, dst = (REF, PORT) if direction == "reference_to_port" else (PORT, REF)
    wire = _json(src, _as_list(build(src)))
    back = _json(dst, [_decode(dst, how, d) for d in wire])
    # the decoded objects re-encode to the JSON they came from, and the
    # destination's own round trip gives the same
    own = _json(dst, [_decode(dst, how, d) for d in _json(dst, _as_list(build(dst)))])
    if how == "decode_alloc":  # decode_alloc drops the heavy fields on both sides
        assert back == own
    else:
        assert back == wire == own


def test_port_decodes_log_config():
    data = PORT.codec.encode(job_volumes_services(PORT))
    task = PORT.codec.decode_job(data).task_groups[0].tasks[0]
    assert isinstance(task.log_config, PORT.job.LogConfig)
    assert (task.log_config.max_files, task.log_config.max_file_size_mb) == (3, 5)
    ref_task = REF.codec.decode_job(REF.codec.encode(job_volumes_services(REF))).task_groups[0]
    assert isinstance(ref_task.tasks[0].log_config, dict)  # ROADMAP C-R7
