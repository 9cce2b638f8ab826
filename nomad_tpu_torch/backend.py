"""Device resolution and the hand-written kernel library.

Takes the roles of the JAX package's ``utils/backend.py`` that the port
needs: where the tensors live, and how the device programs are built.

- **Devices are explicit.** Every entry point takes ``device`` and
  resolves it here. The default is ``"cuda"``; when CUDA is absent the
  call raises. Nothing drops to the CPU on its own: the CPU runs only
  when the caller asks for it (the tests do).
- **The CUDA kernels** live in ``csrc/*.cu`` with a plain C interface.
  ``cuda_library(name)`` compiles ``csrc/<name>.cu`` with ``nvcc`` into
  a shared library under ``build/nomad_tpu_torch/`` at first use and
  loads it with ``ctypes``. The library's file name carries a hash of the
  source, of every shared header (``csrc/*.cuh``) and of the flags, so
  an edited source or header never loads a stale build.
- **Launch counters** are ints on each kernel wrapper
  (``wrapper.launches``, and a form tally where the wrapper keeps one); a
  wrapper adds one through ``count_launch`` where it launches its kernel
  and nowhere else. The server's worker and its commit thread launch on
  one card at once, so the add holds a lock and the counts stay exact.
- **The kernel guard** (``guarded`` / ``guarded_call``): every kernel
  wrapper launches through it, on the CPU as on the card. It checks the
  kernel's circuit breaker, runs the ``kernel.execute`` and
  ``kernel.hang`` chaos sites, and runs the launch on a watchdog thread
  under the breaker's deadline (``resilience/``). A refused or
  timed-out call raises; nothing computes the plain version in its
  place on a CUDA tensor. It also keeps the per-kernel profile
  (``kernel_profile``: calls, builds, wall time) that the HTTP API's
  ``/v1/agent/trace`` serves as ``kernels``.
- **Incremental rescoring** (``incremental_enabled``) resolves the same
  ``NOMAD_TPU_INCREMENTAL`` variable as the JAX package, so one setting
  drives both.
- **The mesh seam** (``MeshConfig``, ``get_mesh``, ``make_mesh``,
  ``shard_put``, ``ShardedTensor``): one process drives a ``dp x mp``
  grid of devices, ``NOMAD_TPU_MESH`` read with the JAX package's
  grammar (off on the CPU and on one card unless asked for; the CPU
  counts as 8 devices). A mesh built by hand may name one card in every
  cell. The closed form and the score matrix launch a kernel per cell,
  the three coupled scans a kernel per cell every step with a merge on
  each groups row's lead between (``device/score.py``); every other
  kernel takes its sharded inputs gathered onto the lead (cell (0, 0)).
  Collectives are copies onto the lead, never ``torch.distributed``.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

REPO_ROOT = Path(__file__).resolve().parent.parent
CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = REPO_ROOT / "build" / "nomad_tpu_torch"

# sm_90a: the H100's full feature target. No --use_fast_math, and
# -fmad=false so no mul+add pair contracts into an FMA: the kernels
# reproduce the reference's separately-rounded sums (the placement
# scores are FMA-contraction bait, see device/score.py).
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
)

_build_lock = threading.Lock()
_libraries: dict[str, ctypes.CDLL] = {}


def resolve_device(device="cuda") -> torch.device:
    """The one place a device string becomes a ``torch.device``. Raises
    instead of substituting the CPU when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "nomad_tpu_torch: CUDA device requested but "
                "torch.cuda.is_available() is False; pass device='cpu' "
                "to run the plain PyTorch versions on the CPU"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"nomad_tpu_torch: unsupported device {dev}")
    return dev


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nomad_tpu_torch: nvcc not found (set CUDA_HOME); the CUDA "
            "kernels are built from csrc/ on the machine with the card"
        )
    return found


def library_hash(name: str, csrc: Path | None = None) -> str:
    """16 hex digits of ``csrc/<name>.cu``, every shared header
    (``csrc/*.cuh``) and the flags: the build's name, so an edited source
    or header never loads a stale library, and the kernel lint's
    fingerprint of it (``csrc`` another tree's sources)."""
    csrc = CSRC_DIR if csrc is None else csrc
    src = csrc / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _library_path(name: str) -> tuple[Path, Path]:
    src = CSRC_DIR / f"{name}.cu"
    return src, BUILD_DIR / f"lib{name}-{library_hash(name)}.so"


def build_all(names=None) -> dict[str, Path]:
    """Compile every (or the named) ``csrc/*.cu`` not built yet, in
    parallel: one nvcc per source, all started together. Raises with the
    compiler's output when one fails."""
    if names is None:
        names = sorted(p.stem for p in CSRC_DIR.glob("*.cu"))
    with _build_lock:
        outs = {n: _library_path(n) for n in names}
        jobs = {}
        for n, (src, out) in outs.items():
            if out.exists():
                continue
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            jobs[n] = (tmp, subprocess.Popen(
                [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            ))
        failures = []
        for n, (tmp, proc) in jobs.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"{n}.cu:\n{log}")
            else:
                os.replace(tmp, outs[n][1])
        if failures:
            raise RuntimeError(
                "nomad_tpu_torch: nvcc failed\n" + "\n".join(failures)
            )
        return {n: out for n, (_src, out) in outs.items()}


def cuda_library(name: str) -> ctypes.CDLL:
    """The loaded C library of ``csrc/<name>.cu``, built at first use."""
    lib = _libraries.get(name)
    if lib is not None:
        return lib
    note_compile()
    path = build_all([name])[name]
    with _build_lock:
        lib = _libraries.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(path))
            _libraries[name] = lib
    return lib


def current_stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


_COUNT_LOCK = threading.Lock()


def count_launch(wrapper, attr: str = "launches", form=None, layout=None, n: int = 1) -> None:
    """Add ``n`` (one launch, or the launches one C call made) to
    ``wrapper.<attr>`` (and to ``wrapper.forms[form]`` when a form is
    given) under a lock: ``+=`` on an attribute is a read, an add and a
    write, and two host threads launching at once would lose counts.
    ``layout`` files a launch under a mesh layout as well
    (``mesh_layouts``): "shard", "merge" or "gathered"; a launch made
    inside ``_gathered`` on this thread is "gathered"."""
    if layout is None and attr == "launches":
        layout = getattr(_launch_layout, "name", None)
    with _COUNT_LOCK:
        setattr(wrapper, attr, getattr(wrapper, attr) + n)
        if form is not None:
            wrapper.forms[form] = wrapper.forms.get(form, 0) + n
        if layout is not None:
            key = (wrapper.__name__, layout)
            _layouts[key] = _layouts.get(key, 0) + n


# launches under a mesh, by (wrapper name, layout)
_layouts: dict[tuple[str, str], int] = {}
# the layout of the launches this thread is making (set by ``_gathered``)
_launch_layout = threading.local()


def mesh_layouts() -> dict[str, int]:
    """``{"<wrapper>:<layout>": launches}`` since the last reset. On a
    CPU mesh the coupled scans' step loop files its plain calls here
    instead (``count_launch(..., "plain_calls", layout=...)``): one a
    step for all its cells, where the card launches one a cell."""
    with _COUNT_LOCK:
        return {f"{name}:{layout}": n for (name, layout), n in sorted(_layouts.items())}


def reset_mesh_layouts() -> None:
    with _COUNT_LOCK:
        _layouts.clear()


def check_launch(status: int, kernel: str) -> None:
    """Raise on a non-zero ``cudaGetLastError`` returned by a C launcher:
    a refused launch never runs, and a later synchronize would not say."""
    if status != 0:
        raise RuntimeError(
            f"nomad_tpu_torch: {kernel} launch failed with cudaError {status}"
        )


def same_device(tensors, device: torch.device, what: str) -> None:
    for t in tensors:
        if t is not None and t.device != device:
            raise ValueError(
                f"{what}: tensor on {t.device}, expected {device}"
            )


# -- the mesh seam --------------------------------------------------------------
#
# The port of the JAX package's ``utils/backend.py`` mesh seam, single
# controller: one process drives a ``dp x mp`` grid of devices, "groups"
# the data-parallel axis over the eval/group lanes and "nodes" the node
# axis, sharded region-major. A node-sharded tensor is a small carrier
# (``ShardedTensor``): one block a grid cell, each on its cell's device.
# Collectives are explicit copies onto the lead device (cell (0, 0)):
# nothing here uses ``torch.distributed``. The degenerate 1x1 mesh keeps
# ``get_mesh()`` callable everywhere and every call on one device.

_MESH_ENV = "NOMAD_TPU_MESH"

# devices a CPU mesh may name: the JAX package's test rig forces 8
# virtual host devices (--xla_force_host_platform_device_count=8)
CPU_MESH_DEVICES = 8

_mesh_lock = threading.Lock()
_mesh_config = None  # cached MeshConfig | None (None = not resolved yet)


class MeshConfig:
    """Resolved mesh decision. ``devices`` is the row-major grid of
    ``dp x mp`` devices when ``active`` (a device may repeat: a mesh
    built explicitly can put every shard on one card), else None;
    ``dp``/``mp`` are the groups/nodes axis sizes (1, 1 when
    degenerate)."""

    __slots__ = ("devices", "dp", "mp", "source")

    def __init__(self, devices, dp: int, mp: int, source: str):
        self.dp = int(dp)
        self.mp = int(mp)
        self.source = source
        if devices is not None:
            devices = [resolve_device(d) for d in devices]
            if len(devices) != self.dp * self.mp:
                raise ValueError(
                    f"mesh {self.dp}x{self.mp} needs {self.dp * self.mp} "
                    f"devices, got {len(devices)}"
                )
            if len({d.type for d in devices}) != 1:
                raise ValueError(f"mesh mixes device types: {devices}")
        self.devices = devices

    @property
    def active(self) -> bool:
        return self.devices is not None

    @property
    def n_node_shards(self) -> int:
        return self.mp if self.devices is not None else 1

    def device(self, i: int, j: int) -> torch.device:
        """The device of grid cell (groups row ``i``, nodes column ``j``)."""
        return self.devices[i * self.mp + j]

    @property
    def lead(self) -> torch.device:
        """Cell (0, 0): where gathered inputs and every result land."""
        return self.devices[0]

    def describe(self) -> dict:
        """The self-describing ``mesh`` block ``bench_torch.py`` embeds in
        its JSON line (per-shard node counts are filled in by the caller
        that knows the padded bucket)."""
        return {
            "active": self.active,
            "shape": [self.dp, self.mp],
            "axis_names": ["groups", "nodes"],
            "source": self.source,
            "devices": [str(d) for d in self.devices or ()],
        }


def make_mesh(dp: int, mp: int, devices="cuda", source: str = "explicit") -> MeshConfig:
    """A mesh built by hand: ``devices`` is one device for every cell
    (the shards share it) or a list of ``dp * mp`` devices, row-major."""
    if isinstance(devices, (str, torch.device)):
        devices = [devices] * (dp * mp)
    if dp * mp == 1:
        return MeshConfig(None, 1, 1, source)
    return MeshConfig(list(devices), dp, mp, source)


def parse_mesh_spec(spec: str):
    """``NOMAD_TPU_MESH`` grammar: ``off``/``0``/``none`` (degenerate),
    ``auto`` (shape from every visible device), or ``dp,mp``. Returns
    "off", "auto", or a (dp, mp) int tuple; raises ValueError on junk."""
    s = (spec or "").strip().lower()
    if s in ("off", "0", "none"):
        return "off"
    if s == "auto":
        return "auto"
    parts = s.split(",")
    if len(parts) != 2:
        raise ValueError(
            f"bad {_MESH_ENV}={spec!r}: expected 'dp,mp', 'auto', or 'off'"
        )
    dp, mp = int(parts[0]), int(parts[1])
    if dp < 1 or mp < 1:
        raise ValueError(f"bad {_MESH_ENV}={spec!r}: axes must be >= 1")
    if mp & (mp - 1):
        raise ValueError(
            f"bad {_MESH_ENV}={spec!r}: nodes axis must be a power of two "
            "(it must divide the padded node bucket)"
        )
    return (dp, mp)


def auto_mesh_shape(n_devices: int) -> tuple[int, int]:
    """Shape rule for ``auto``: the largest power-of-two device count,
    the node axis capped at 8 (the smallest node bucket), the rest on
    the groups axis. 8 devices -> (2, 4)."""
    total = 1
    while total * 2 <= n_devices:
        total *= 2
    if total <= 1:
        return (1, 1)
    mp = min(8, total // 2) if total > 2 else total
    return (total // mp, mp)


def _resolve_mesh() -> MeshConfig:
    spec = os.environ.get(_MESH_ENV)
    cuda = torch.cuda.is_available()
    n_devices = torch.cuda.device_count() if cuda else CPU_MESH_DEVICES
    if spec is None:
        # unset: on only with more than one card. The CPU and a single
        # card stay degenerate unless the caller opts in.
        if not cuda or n_devices <= 1:
            return MeshConfig(None, 1, 1, "default-off")
        parsed, source = "auto", "auto-detected"
    else:
        parsed, source = parse_mesh_spec(spec), f"env:{spec.strip()}"
    if parsed == "off":
        return MeshConfig(None, 1, 1, source)
    dp, mp = auto_mesh_shape(n_devices) if parsed == "auto" else parsed
    if dp * mp > n_devices:
        raise ValueError(
            f"{_MESH_ENV} asks for {dp}x{mp}={dp * mp} devices but only "
            f"{n_devices} are visible"
        )
    if dp * mp == 1:
        return MeshConfig(None, 1, 1, source)
    if cuda:
        devices = [torch.device("cuda", i) for i in range(dp * mp)]
    else:
        devices = [torch.device("cpu")] * (dp * mp)
    return MeshConfig(devices, dp, mp, source)


def get_mesh() -> MeshConfig:
    """The process-wide mesh, resolved once from ``NOMAD_TPU_MESH``.
    Call ``reset_mesh()`` after changing the variable."""
    global _mesh_config
    cfg = _mesh_config
    if cfg is not None:
        return cfg
    with _mesh_lock:
        if _mesh_config is None:
            _mesh_config = _resolve_mesh()
        return _mesh_config


def reset_mesh() -> None:
    global _mesh_config
    with _mesh_lock:
        _mesh_config = None


class ShardedTensor:
    """A tensor laid out over a mesh: ``axes`` names, per dimension, the
    mesh axis it is split over ("groups", "nodes" or None), and
    ``block(i, j)`` is the part grid cell (i, j) holds, contiguous, on
    that cell's device. Cells that hold the same part on the same device
    share one tensor. Never written after it is made."""

    __slots__ = ("cfg", "axes", "shape", "dtype", "_blocks")

    def __init__(self, cfg: MeshConfig, axes: tuple, shape: tuple, dtype, blocks: dict):
        self.cfg = cfg
        self.axes = axes
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self._blocks = blocks

    @property
    def device(self) -> torch.device:
        return self.cfg.lead

    def split(self, ax: str) -> int:
        return {"groups": self.cfg.dp, "nodes": self.cfg.mp}[ax] if ax in self.axes else 1

    def block(self, i: int, j: int) -> torch.Tensor:
        return self._blocks[(i, j)]

    def index(self, i: int, j: int) -> tuple:
        """The slices of the whole tensor that cell (i, j) holds."""
        out = []
        for d, ax in enumerate(self.axes):
            if ax is None:
                out.append(slice(None))
                continue
            seg = self.shape[d] // self.split(ax)
            k = i if ax == "groups" else j
            out.append(slice(k * seg, (k + 1) * seg))
        return tuple(out)

    def pieces(self):
        """(cell, slices, tensor) of each distinct block, row-major."""
        seen = set()
        for i in range(self.cfg.dp):
            for j in range(self.cfg.mp):
                t = self._blocks[(i, j)]
                if id(t) not in seen:
                    seen.add(id(t))
                    yield (i, j), self.index(i, j), t

    def gather(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (default the lead): each part
        copied once, from the first cell that holds it."""
        dev = self.cfg.lead if device is None else device
        out = torch.empty(self.shape, dtype=self.dtype, device=dev)
        done = set()
        for _cell, idx, t in self.pieces():
            key = tuple((s.start, s.stop) for s in idx)
            if key not in done:
                done.add(key)
                out[idx].copy_(t)
        return out

    def with_blocks(self, fresh: dict) -> "ShardedTensor":
        """A new carrier whose parts at the node columns in ``fresh``
        (column -> whole part, on any device) are replaced; every other
        cell keeps its tensor."""
        made: dict = {}
        blocks = {}
        for (i, j), t in self._blocks.items():
            if j in fresh:
                dev = self.cfg.device(i, j)
                key = (dev, j)
                if key not in made:
                    made[key] = fresh[j].to(dev, copy=True)
                blocks[(i, j)] = made[key]
            else:
                blocks[(i, j)] = t
        return ShardedTensor(self.cfg, self.axes, self.shape, self.dtype, blocks)


def is_sharded(x) -> bool:
    return isinstance(x, ShardedTensor)


def gather(x, device=None):
    """A ``ShardedTensor`` as one tensor on ``device`` (default its
    lead); anything else unchanged."""
    return x.gather(device) if isinstance(x, ShardedTensor) else x


def shard_put(x, axes, cfg: MeshConfig | None = None, device="cuda"):
    """Place ``x`` (numpy or tensor) on the mesh, dimension ``d`` split
    over the mesh axis ``axes[d]`` ("groups", "nodes" or None; trailing
    Nones may be left out): the sanctioned upload seam. A degenerate
    mesh gives a plain tensor on ``device``; an axis whose size does not
    divide its dimension is not split, and a tensor split over no axis
    is a plain tensor on the lead — one controller reads it there."""
    import numpy as np

    if cfg is None:
        cfg = get_mesh()
    if isinstance(x, torch.Tensor):
        t = x
    else:
        t = torch.from_numpy(np.ascontiguousarray(x))
    if not cfg.active:
        return t.to(resolve_device(device))
    shape = tuple(t.shape)
    sizes = {"groups": cfg.dp, "nodes": cfg.mp}
    use = []
    for d in range(len(shape)):
        ax = axes[d] if d < len(axes) else None
        use.append(ax if ax is not None and shape[d] % sizes[ax] == 0 else None)
    use = tuple(use)
    if all(ax is None for ax in use):
        return t.to(cfg.lead)
    carrier = ShardedTensor(cfg, use, shape, t.dtype, {})
    made: dict = {}
    for i in range(cfg.dp):
        for j in range(cfg.mp):
            dev = cfg.device(i, j)
            idx = carrier.index(i, j)
            key = (dev, tuple((s.start, s.stop) for s in idx))
            if key not in made:
                made[key] = t[idx].to(
                    device=dev, memory_format=torch.contiguous_format, copy=True
                )
            carrier._blocks[(i, j)] = made[key]
    return carrier


# -- the kernel guard ----------------------------------------------------------
#
# The port of the JAX package's ``traced_jit`` wrapper body (its
# ``_profiled``), minus the CPU fallback: a refused call raises
# ``KernelUnavailable``, a missed deadline ``KernelDeadlineExceeded``, and
# the server's worker nacks the eval so the broker redelivers it.

# builds started in this process: a library's first load (nvcc when not
# built yet) and a Triton specialization's first call. The watchdog
# extends a call's deadline to the compile deadline when this moved
# during the call (the JAX package's trace count plays this role).
_compile_lock = threading.Lock()
_compiles = 0

# set on a thread while it runs a guarded launch (a nested wrapper call
# is covered by the outer guard) or times kernels (``direct_launches``)
_guard_tls = threading.local()

_WATCHDOG_ENV = "NOMAD_TPU_KERNEL_WATCHDOG"


def note_compile() -> None:
    global _compiles
    with _compile_lock:
        _compiles += 1
    # the guard reads this thread's flag, so that a build started by
    # another lane's call is not filed under this call
    _guard_tls.built = True


@contextlib.contextmanager
def direct_launches():
    """Kernel wrappers called on this thread inside the block launch
    straight through the guard: no breaker, no chaos site, no watchdog
    hand-off or synchronize. For timing a kernel alone, where the guard's
    host work and its wait would sit inside the measured window."""
    prev = getattr(_guard_tls, "inside", False)
    _guard_tls.inside = True
    try:
        yield
    finally:
        _guard_tls.inside = prev


# -- the per-kernel profile ----------------------------------------------------
#
# What the JAX package's ``kernel_profile`` keeps for its traced_jit
# kernels, kept here by the guard for each kernel wrapper, keyed by the
# JAX package's kernel names (the guard's names): the calls, how many of
# them started a build (``note_compile`` called on the launching thread:
# a library's first load, a new Triton specialization), the wall time,
# and the recent builds with the shapes that caused them. The wall time
# runs from the guard's entry to the end of the event synchronize, so it
# covers the device work; a call that started a build includes the
# build. Launches straight through the guard (a capture, a nested
# wrapper, ``direct_launches``) are not counted.

_KERNEL_TRACE_EVENTS = 32  # recent builds kept per kernel

_profile_lock = threading.Lock()
_kernel_stats: dict[str, dict] = {}
_kernel_traces: dict[str, list[dict]] = {}
_last_trace_shape: dict[str, str] = {}


def _shape_sig(args, kwargs) -> str:
    """The call's shapes and scalars, as the JAX package writes a trace's
    abstract signature (``dtype[d0,d1]``)."""
    parts = []
    for a in list(args) + [v for _, v in sorted(kwargs.items())]:
        if isinstance(a, torch.Tensor):
            dt = str(a.dtype).replace("torch.", "")
            parts.append(f"{dt}[{','.join(str(d) for d in a.shape)}]")
        elif isinstance(a, (bool, int, float, str)):
            parts.append(repr(a))
    return " ".join(parts)[:256]


def _record_kernel_call(name: str, seconds: float, built: bool, sig) -> str | None:
    """Count the call in the profile; the shape of a call that started a
    build (else None)."""
    shape = None
    if built:
        shape = sig() if sig is not None else ""
    with _profile_lock:
        st = _kernel_stats.get(name)
        if st is None:
            st = _kernel_stats[name] = {"calls": 0, "traces": 0, "total_s": 0.0}
        st["calls"] += 1
        st["total_s"] += seconds
        if built:
            _last_trace_shape[name] = shape
            st["traces"] += 1
            events = _kernel_traces.setdefault(name, [])
            events.append({"shape": shape, "wall_s": round(seconds, 6)})
            del events[:-_KERNEL_TRACE_EVENTS]
    return shape


def kernel_profile() -> dict:
    """Per-kernel profile snapshot, with the JAX package's keys: call and
    build counts, cumulative wall time, the last shape that started a
    build and the recent builds (``/v1/agent/trace``'s ``kernels``)."""
    with _profile_lock:
        return {
            name: {
                "calls": st["calls"],
                "traces": st["traces"],
                "total_ms": round(st["total_s"] * 1000.0, 3),
                "last_trace_shape": _last_trace_shape.get(name, ""),
                "recent_traces": list(_kernel_traces.get(name, ())),
            }
            for name, st in _kernel_stats.items()
        }


def reset_kernel_profile() -> None:
    with _profile_lock:
        _kernel_stats.clear()
        _kernel_traces.clear()
        _last_trace_shape.clear()


def guarded_call(name: str, device: torch.device, launch, sig=None):
    """Run ``launch()`` (a kernel wrapper's body: the launch on a CUDA
    tensor, the plain version on a CPU tensor) behind the breaker
    ``name``, in the JAX package's order:

    1. the breaker: refused → ``KernelUnavailable``, nothing launched,
       ``nomad.resilience.refused_calls`` counted;
    2. the ``kernel.execute`` site (a raise counts as a failure);
    3. on a watchdog thread, under the breaker's execute deadline
       (extended to its compile deadline when a build started during the
       call): the ``kernel.hang`` site; if the caller has given up
       meanwhile, return without launching
       (``nomad.resilience.abandoned_skips``); else the launch on the
       caller's device and stream, then a CUDA event synchronize on that
       stream, so that the deadline covers the work itself;
    4. ``record_success``, or ``record_failure`` and re-raise, or
       ``record_timeout`` and raise ``KernelDeadlineExceeded``;
    5. the call in the per-kernel profile (``kernel_profile``), with
       ``sig()`` (the call's shapes) when it started a build, and a
       ``kernel:<name>`` span when the caller is inside a span.

    While a CUDA graph is being captured, or inside a guarded launch or
    ``direct_launches``, the launch runs straight through (an event
    synchronize and a thread hand-off are illegal in a capture, and an
    outer guard already covers a nested call)."""
    if getattr(_guard_tls, "inside", False) or (
        device.type == "cuda" and torch.cuda.is_current_stream_capturing()
    ):
        return launch()
    from .chaos.plane import chaos_site
    from .obs.trace import global_tracer
    from .resilience.breaker import breaker_for, forced_open
    from .resilience.errors import KernelDeadlineExceeded, KernelUnavailable
    from .resilience.watchdog import abandoned, global_executor
    from .utils.metrics import global_metrics

    t0 = time.perf_counter()
    br = breaker_for(name)
    if not br.allow():
        global_metrics.incr("nomad.resilience.refused_calls")
        snap = br.snapshot()
        state = "forced_open" if forced_open() else snap["state"]
        raise KernelUnavailable(name, state, snap["probe_in_s"])
    # a raise here models a device-side failure (a lost context, an out
    # of memory); the worker's batch path falls back to single-eval runs
    try:
        chaos_site("kernel.execute")
    except Exception as e:
        br.record_failure(e)
        raise
    before = _compiles
    # PyTorch's current stream is per thread: read the caller's here
    stream = torch.cuda.current_stream(device) if device.type == "cuda" else None
    built = [False]

    def thunk():
        # a hang here models a wedged launch or copy; only the watchdog
        # deadline gets the caller's thread back
        chaos_site("kernel.hang")
        if abandoned():
            # the caller already raised: a late launch could write the
            # scratch (grid-barrier counters, sort words) of the next call
            global_metrics.incr("nomad.resilience.abandoned_skips")
            return None
        _guard_tls.inside = True
        _guard_tls.built = False
        try:
            if stream is None:
                return launch()
            with torch.cuda.device(device), torch.cuda.stream(stream):
                out = launch()
                done = torch.cuda.Event()
                done.record(stream)
            done.synchronize()
            return out
        finally:
            _guard_tls.inside = False
            built[0] = _guard_tls.built

    try:
        if os.environ.get(_WATCHDOG_ENV, "1") != "0" and br.execute_deadline > 0:
            out = global_executor.run(
                thunk,
                name=name,
                deadline_s=br.execute_deadline,
                extend_deadline_s=br.compile_deadline,
                extend_probe=lambda: _compiles > before,
            )
        else:
            out = thunk()
    except KernelDeadlineExceeded as e:
        br.record_timeout(e)
        raise
    except Exception as e:
        br.record_failure(e)
        raise
    br.record_success()
    seconds = time.perf_counter() - t0
    shape = _record_kernel_call(name, seconds, built[0], sig)
    # a ``kernel:<name>`` span under the caller's span, when it has one
    global_tracer.record_kernel(name, seconds, traced=built[0], shape=shape)
    return out


def guarded(name: str, sharded=None, build_budget=None, library=None, symbols=()):
    """Decorator form of ``guarded_call`` for a kernel wrapper whose first
    argument (or ``capacity``) is a tensor on the call's device. The
    decorated function is the module's wrapper: its counters
    (``launches``, ``forms``) are set on it.

    Inputs laid out over a mesh (``ShardedTensor``) go to ``sharded``
    (same arguments), behind the same guard on the mesh's lead device;
    without one, the wrapper's kernel takes them gathered onto the lead
    (each launch this makes is filed under the "gathered" layout).

    The wrapper joins the kernel registry (``kernel_registry``) under
    ``name``, with its build budget (the builds a process may start for
    it, ``analysis/retrace.py``) and where its device code comes from:
    ``library`` (``csrc/<library>.cu``) and the exported ``symbols`` it
    launches, or no library for the Triton kernel."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            first = args[0] if args else kwargs["capacity"]
            launch = lambda: fn(*args, **kwargs)  # noqa: E731
            if any(isinstance(a, ShardedTensor) for a in (*args, *kwargs.values())):
                if sharded is not None:
                    launch = lambda: sharded(*args, **kwargs)  # noqa: E731
                else:
                    launch = lambda: _gathered(fn, first.device, args, kwargs)  # noqa: E731
            out = guarded_call(
                name, first.device, launch, sig=lambda: _shape_sig(args, kwargs),
            )
            _record_call(name, fn.__name__, args, kwargs, out)
            return out

        _register_kernel(name, call, build_budget, library, symbols, guard=name)
        return call

    return wrap


def inside_guard(name: str, guard: str, build_budget=None, library=None, symbols=()):
    """Registers a kernel wrapper that launches only inside another
    kernel's guarded call (``guard``): the mesh's cross-shard merge runs
    inside the closed form's. Its calls are recorded like a guarded
    wrapper's; the breaker, watchdog and profile are the outer guard's."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            out = fn(*args, **kwargs)
            _record_call(name, fn.__name__, args, kwargs, out)
            return out

        _register_kernel(name, call, build_budget, library, symbols, guard=guard)
        return call

    return wrap


# -- the kernel registry --------------------------------------------------------
#
# The port of the JAX package's ``traced_jit`` registry: every kernel
# wrapper, keyed by the JAX package's kernel names, with its build
# budget and its device code's origin. The kernel lint
# (``analysis/kernellint``) exercises, fingerprints and audits the fleet
# through it; ``recording_calls`` hands it every wrapper call (inputs
# and outputs) made inside the block.


@dataclasses.dataclass
class KernelEntry:
    name: str  # the JAX package's kernel name (the guard's name)
    wrappers: list  # the decorated functions registered under it
    build_budget: int | None  # builds a process may start for it
    library: str | None  # csrc/<library>.cu; None: the Triton kernel
    symbols: tuple  # the library's exported launchers it calls
    guard: str  # the guarded call it launches under
    called: bool = False  # a wrapper call returned in this process

    @property
    def module(self) -> str:
        return self.wrappers[0].__module__

    @property
    def route(self) -> str:
        return "triton" if self.library is None else "cuda"


_registry_lock = threading.Lock()
_kernel_registry: dict[str, KernelEntry] = {}
_recorders: list[list] = []


def _register_kernel(name, fn, build_budget, library, symbols, guard) -> None:
    with _registry_lock:
        entry = _kernel_registry.get(name)
        if entry is None:
            _kernel_registry[name] = KernelEntry(
                name, [fn], build_budget, library, tuple(symbols), guard,
            )
            return
        # a second wrapper under one name (the gang auction's id form)
        # adds its symbols; its budget and library are the name's
        if (build_budget, library) != (entry.build_budget, entry.library):
            raise ValueError(
                f"kernel {name}: wrappers disagree on its budget or library"
            )
        entry.wrappers.append(fn)
        entry.symbols = tuple(dict.fromkeys(entry.symbols + tuple(symbols)))


def kernel_registry() -> dict[str, KernelEntry]:
    """The registered kernels, by name (a snapshot)."""
    with _registry_lock:
        return dict(_kernel_registry)


def build_counts() -> dict[str, int]:
    """Builds a process has started, per guarded kernel: its calls that
    started one (``kernel_profile``'s ``traces``)."""
    return {name: st["traces"] for name, st in kernel_profile().items()}


def build_budgets() -> dict[str, int]:
    with _registry_lock:
        return {
            name: e.build_budget for name, e in _kernel_registry.items()
            if e.build_budget is not None
        }


@dataclasses.dataclass
class KernelCall:
    name: str  # the kernel's registry name
    wrapper: str  # the wrapper function called (a name may have two)
    args: tuple
    kwargs: dict
    out: object


@contextlib.contextmanager
def recording_calls():
    """Every registered wrapper's calls on any thread inside the block,
    in order, as ``KernelCall`` (inputs and outputs kept alive)."""
    calls: list = []
    with _registry_lock:
        _recorders.append(calls)
    try:
        yield calls
    finally:
        with _registry_lock:
            _recorders.remove(calls)


def _record_call(name, wrapper, args, kwargs, out) -> None:
    entry = _kernel_registry.get(name)
    if entry is not None and not entry.called:
        entry.called = True
    if not _recorders:
        return
    call = KernelCall(name, wrapper, tuple(args), dict(kwargs), out)
    with _registry_lock:
        for calls in _recorders:
            calls.append(call)


def _gathered(fn, lead, args, kwargs):
    """``fn`` on its sharded inputs gathered onto ``lead``; the launches it
    makes on this thread are filed under the "gathered" layout."""
    args = [gather(a, lead) for a in args]
    kwargs = {k: gather(v, lead) for k, v in kwargs.items()}
    prev = getattr(_launch_layout, "name", None)
    _launch_layout.name = "gathered"
    try:
        return fn(*args, **kwargs)
    finally:
        _launch_layout.name = prev


# -- incremental score-state seam ---------------------------------------------
#
# ``NOMAD_TPU_INCREMENTAL`` gates the DeviceStateCache's score-state
# persistence (device/cache.py): with it on, the per-pass ``used``
# tensor stays device-resident across passes and only dirty rows
# re-upload. Resolved once; the gate is Python-level (the resident
# tensor has the same shape and dtype as a fresh upload), so flipping it
# never changes what a kernel is launched with.

_INCR_ENV = "NOMAD_TPU_INCREMENTAL"

_incr_lock = threading.Lock()
_incr_enabled = None  # cached bool | None (None = not resolved yet)


def incremental_enabled() -> bool:
    """The process-wide incremental-rescoring decision, resolved once
    from ``NOMAD_TPU_INCREMENTAL`` (``on``/``1``/``true`` enable; unset
    or anything else is off — the from-scratch path). Call
    ``reset_incremental()`` after changing the env in tests."""
    global _incr_enabled
    val = _incr_enabled
    if val is not None:
        return val
    with _incr_lock:
        if _incr_enabled is None:
            spec = os.environ.get(_INCR_ENV, "")
            _incr_enabled = spec.strip().lower() in ("on", "1", "true")
        return _incr_enabled


def reset_incremental() -> None:
    global _incr_enabled
    with _incr_lock:
        _incr_enabled = None
