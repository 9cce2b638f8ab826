"""Node fingerprinting: detect attributes, resources, and drivers.

Reference: client/fingerprint/ (~40 detectors orchestrated by
client/fingerprint_manager.go). This build runs a detector list over the
same attribute namespaces; each detector is isolated (a failing probe
never aborts fingerprinting, matching the manager's per-fingerprinter
error handling) and cheap-probe-first (cloud env detectors respect a
short timeout, like env_aws/env_gce do).

Detector parity map (reference file → here):
- cpu.go / memory.go / storage.go      → _fp_cpu, _fp_memory, _fp_storage
- arch.go / host.go / signal.go        → _fp_host
- network.go                           → _fp_network (iface, IP, speed)
- bridge.go / cni.go                   → _fp_bridge (kernel module probe)
- cgroup.go                            → _fp_cgroup (v1/v2 mountpoint)
- env_aws.go / env_gce.go / env_azure  → _fp_cloud (metadata endpoints;
  gated by NOMAD_TPU_CLOUD_FINGERPRINT — zero-egress hosts skip)
- consul.go / vault.go                 → _fp_consul_vault (env-var probes
  only; the integrations themselves are descoped)
- nomad.go                             → _fp_nomad
- plugins via manager                  → driver loop in fingerprint_node
- accelerators (plugins/device)        → _fp_gpu (this build's native
  accelerator is the CUDA card itself: the torch.cuda device table when
  CUDA is available; the JAX package's ``_fp_tpu`` reads jax's)
"""

from __future__ import annotations

import glob
import hashlib
import multiprocessing
import os
import platform
import shutil
import socket
import uuid

from ..structs import Node, NodeResources
from ..structs.resources import NetworkResource

from .. import __version__


def _read(path: str) -> str:
    try:
        with open(path) as f:
            return f.read().strip()
    except OSError:
        return ""


def _total_memory_mb() -> int:
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    return int(line.split()[1]) // 1024
    except OSError:
        pass
    return 4096


def _disk_mb(path: str = "/") -> int:
    try:
        st = os.statvfs(path)
        return int(st.f_frsize * st.f_blocks / (1024 * 1024))
    except OSError:
        return 50 * 1024


def _cpu_mhz() -> int:
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.lower().startswith("cpu mhz"):
                    return int(float(line.split(":")[1]))
    except OSError:
        pass
    return 2000


# -- detectors (client/fingerprint/*.go) -------------------------------------


def _fp_cpu(node: Node, ctx: dict) -> None:
    cores = multiprocessing.cpu_count()
    mhz = _cpu_mhz()
    model = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.lower().startswith("model name"):
                    model = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    node.attributes.update(
        {
            "cpu.numcores": str(cores),
            "cpu.frequency": str(mhz),
            "cpu.totalcompute": str(cores * mhz),
        }
    )
    if model:
        node.attributes["cpu.modelname"] = model
    ctx["cpu"] = cores * mhz


def _fp_memory(node: Node, ctx: dict) -> None:
    mb = _total_memory_mb()
    node.attributes["memory.totalbytes"] = str(mb * 1024 * 1024)
    ctx["memory_mb"] = mb


def _fp_storage(node: Node, ctx: dict) -> None:
    path = ctx.get("data_dir") or "/"
    mb = _disk_mb(path)
    node.attributes.update(
        {
            "unique.storage.volume": path,
            "unique.storage.bytestotal": str(mb * 1024 * 1024),
            "unique.storage.bytesfree": str(
                _free_mb(path) * 1024 * 1024
            ),
        }
    )
    ctx["disk_mb"] = mb


def _free_mb(path: str) -> int:
    try:
        st = os.statvfs(path)
        return int(st.f_frsize * st.f_bavail / (1024 * 1024))
    except OSError:
        return 0


def _fp_host(node: Node, ctx: dict) -> None:
    node.attributes.update(
        {
            "kernel.name": platform.system().lower(),
            "kernel.version": platform.release(),
            "arch": platform.machine(),
            "os.name": platform.system().lower(),
            "os.version": platform.version(),
            "unique.hostname": socket.gethostname(),
        }
    )


def _fp_network(node: Node, ctx: dict) -> None:
    """network.go: default interface, its IP, and link speed (Mbits)."""
    iface, ip = None, None
    try:
        # the default-route trick: a UDP "connect" picks the egress iface
        s = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        try:
            s.connect(("192.0.2.1", 9))  # TEST-NET: never actually sent
            ip = s.getsockname()[0]
        finally:
            s.close()
    except OSError:
        pass
    speed = 1000
    for path in sorted(glob.glob("/sys/class/net/*")):
        name = os.path.basename(path)
        if name == "lo":
            continue
        if _read(os.path.join(path, "operstate")) == "up":
            iface = iface or name
            raw = _read(os.path.join(path, "speed"))
            if raw and raw.lstrip("-").isdigit() and int(raw) > 0:
                speed = int(raw)
            break
    if iface:
        node.attributes["unique.network.interface"] = iface
    if ip:
        node.attributes["unique.network.ip-address"] = ip
    node.attributes["network.speed"] = str(speed)
    ctx["net_speed"] = speed


def _fp_bridge(node: Node, ctx: dict) -> None:
    """bridge.go: is the kernel bridge module available?"""
    if os.path.isdir("/sys/class/net/docker0") or os.path.exists(
        "/sys/module/bridge"
    ):
        node.attributes["network.bridge"] = "1"


def _fp_cgroup(node: Node, ctx: dict) -> None:
    """cgroup.go: cgroup mountpoint + version (drives exec isolation)."""
    if os.path.isdir("/sys/fs/cgroup"):
        v2 = os.path.exists("/sys/fs/cgroup/cgroup.controllers")
        node.attributes["unique.cgroup.mountpoint"] = "/sys/fs/cgroup"
        node.attributes["unique.cgroup.version"] = "v2" if v2 else "v1"


def _fp_cloud(node: Node, ctx: dict) -> None:
    """env_aws/env_gce/env_azure: cloud metadata — network probes are
    gated (zero-egress hosts must not stall fingerprinting); cheap
    filesystem hints run unconditionally."""
    vendor = _read("/sys/class/dmi/id/sys_vendor").lower()
    product = _read("/sys/class/dmi/id/product_name").lower()
    if "amazon" in vendor or "ec2" in product:
        node.attributes["platform.aws"] = "1"
    elif "google" in vendor or "google" in product:
        node.attributes["platform.gce"] = "1"
    elif "microsoft" in vendor:
        node.attributes["platform.azure"] = "1"
    if os.environ.get("NOMAD_TPU_CLOUD_FINGERPRINT") != "1":
        return
    # full metadata probes (169.254.169.254) only when explicitly enabled


def _fp_consul_vault(node: Node, ctx: dict) -> None:
    """consul.go/vault.go reduced to env discovery (integration descoped;
    the attributes still drive constraints)."""
    if os.environ.get("CONSUL_HTTP_ADDR"):
        node.attributes["consul.addr"] = os.environ["CONSUL_HTTP_ADDR"]
    if os.environ.get("VAULT_ADDR"):
        node.attributes["vault.addr"] = os.environ["VAULT_ADDR"]


def _fp_nomad(node: Node, ctx: dict) -> None:
    node.attributes["nomad.version"] = __version__
    node.attributes["nomad.revision"] = "tpu-native"


def _fp_gpu(node: Node, ctx: dict) -> None:
    """Accelerator detection — this build's native accelerator is the
    CUDA card: surface the torch.cuda device table when CUDA is
    available (``gpu.count``, and ``gpu.type`` as
    ``torch.cuda.get_device_name``). A host without CUDA gets neither."""
    import torch

    try:
        if not torch.cuda.is_available():
            return
        count = torch.cuda.device_count()
        if count:
            node.attributes["gpu.count"] = str(count)
            node.attributes["gpu.type"] = torch.cuda.get_device_name(0)
    except Exception:
        return


def normalize_device_class(kind: str) -> str:
    """Canonicalize an accelerator kind string into a device class slug:
    lowercase, spaces → dashes, ``TPU v5e`` → ``tpu-v5e``,
    ``NVIDIA A100`` → ``gpu-a100``-style names pass through as typed."""
    slug = "-".join(str(kind).strip().lower().split())
    return slug


def _fp_device_class(node: Node, ctx: dict) -> None:
    """Heterogeneity fingerprint: derive ``node.device_class`` from the
    detected accelerator (``gpu.type`` from _fp_gpu), with an explicit
    ``NOMAD_TPU_DEVICE_CLASS`` operator override winning. Hosts with no
    accelerator stay class-less ("") so existing clusters schedule
    bit-identically until an operator opts a fleet in."""
    override = os.environ.get("NOMAD_TPU_DEVICE_CLASS", "")
    if override:
        node.device_class = normalize_device_class(override)
        node.attributes["device.class"] = node.device_class
        return
    if node.device_class:
        # pre-configured (client config) — keep, but surface as an attr
        node.attributes["device.class"] = node.device_class
        return
    kind = node.attributes.get("gpu.type", "")
    if kind:
        slug = normalize_device_class(kind)
        if not slug.startswith(("gpu", "nvidia")):
            slug = f"gpu-{slug}"
        node.device_class = slug
        node.attributes["device.class"] = slug


TOPOLOGY_LEVELS = ("rack", "pod", "ici")


def normalize_topology(spec: str) -> dict[str, str]:
    """Parse a ``rack=r03,pod=p1,ici=2.1`` coordinate spec into a
    topology dict. Unknown levels and malformed entries are dropped —
    an operator typo degrades to topology-less, never to a crash."""
    topo: dict[str, str] = {}
    for entry in str(spec).split(","):
        if "=" not in entry:
            continue
        level, _, value = entry.partition("=")
        level = level.strip().lower()
        value = value.strip().lower()
        if level in TOPOLOGY_LEVELS and value:
            topo[level] = value
    return topo


def _fp_topology(node: Node, ctx: dict) -> None:
    """Topology fingerprint: rack/pod/ICI coordinates for gang-aware
    placement. Precedence mirrors _fp_device_class: an explicit
    ``NOMAD_TPU_TOPOLOGY`` operator override wins, then pre-configured
    coordinates (client config), then — when an accelerator was detected
    (``gpu.type`` from _fp_gpu) — a deterministic derivation from the
    node name, so a fleet brought up without cabling data still gets
    stable, restart-invariant coordinates. Hosts with no accelerator and
    no override stay topology-less ({}) so existing clusters schedule
    bit-identically until an operator opts a fleet in."""
    override = os.environ.get("NOMAD_TPU_TOPOLOGY", "")
    if override:
        topo = normalize_topology(override)
        if topo:
            node.topology = topo
            for level, value in topo.items():
                node.attributes[f"topology.{level}"] = value
        return
    if node.topology:
        # pre-configured (client config) — keep, but surface as attrs
        for level, value in node.topology.items():
            node.attributes[f"topology.{level}"] = value
        return
    if not node.attributes.get("gpu.type", ""):
        return
    # derive stable coordinates from the node identity: 16 racks of a
    # 4-pod fabric, ICI coordinate = (pod, rack-within-pod). blake2b of
    # the name (not the uuid) so a re-registered host keeps its slot.
    h = int.from_bytes(
        hashlib.blake2b((node.name or node.id).encode(), digest_size=4).digest(),
        "big",
    )
    rack = h % 16
    pod = (h >> 8) % 4
    node.topology = {
        "rack": f"r{rack:02d}",
        "pod": f"p{pod}",
        "ici": f"{pod}.{rack % 4}",
    }
    for level, value in node.topology.items():
        node.attributes[f"topology.{level}"] = value


DETECTORS = (
    _fp_cpu,
    _fp_memory,
    _fp_storage,
    _fp_host,
    _fp_network,
    _fp_bridge,
    _fp_cgroup,
    _fp_cloud,
    _fp_consul_vault,
    _fp_nomad,
    _fp_gpu,
    _fp_device_class,  # after _fp_gpu: consumes its gpu.type attribute
    _fp_topology,  # after _fp_gpu: gates derivation on its gpu.type
)


def fingerprint_node(
    node: Node | None = None, *, data_dir: str = "", drivers=None
) -> Node:
    """Build (or refresh) a Node from the host. ``drivers`` is the driver
    registry used for driver.* attributes (client/fingerprint_manager.go
    fingerprints plugins through the same pass). Detector failures are
    isolated per fingerprinter, as in the manager."""
    node = node or Node(id=str(uuid.uuid4()))
    node.name = node.name or socket.gethostname()
    ctx: dict = {"data_dir": data_dir}
    for det in DETECTORS:
        try:
            det(node, ctx)
        except Exception:  # noqa: BLE001 — a probe must never kill startup
            pass
    node.node_resources = NodeResources(
        cpu=ctx.get("cpu", 4000),
        memory_mb=ctx.get("memory_mb", 4096),
        disk_mb=ctx.get("disk_mb", 50 * 1024),
        networks=[NetworkResource(mbits=ctx.get("net_speed", 1000))],
    )
    if drivers is not None:
        for name, drv in drivers.items():
            healthy = drv.fingerprint()
            node.drivers[name] = healthy
            node.attributes[f"driver.{name}"] = "1" if healthy else "0"
    node.compute_class()
    return node
