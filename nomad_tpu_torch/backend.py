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
  place on a CUDA tensor.
- **Incremental rescoring** (``incremental_enabled``) resolves the same
  ``NOMAD_TPU_INCREMENTAL`` variable as the JAX package, so one setting
  drives both.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
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


def _library_path(name: str) -> tuple[Path, Path]:
    src = CSRC_DIR / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return src, BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


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


def count_launch(wrapper, attr: str = "launches", form=None) -> None:
    """Add one to ``wrapper.<attr>`` (and to ``wrapper.forms[form]`` when
    a form is given) under a lock: ``+=`` on an attribute is a read, an
    add and a write, and two host threads launching at once would lose
    counts."""
    with _COUNT_LOCK:
        setattr(wrapper, attr, getattr(wrapper, attr) + 1)
        if form is not None:
            wrapper.forms[form] = wrapper.forms.get(form, 0) + 1


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


def guarded_call(name: str, device: torch.device, launch):
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
       ``record_timeout`` and raise ``KernelDeadlineExceeded``.

    While a CUDA graph is being captured, or inside a guarded launch or
    ``direct_launches``, the launch runs straight through (an event
    synchronize and a thread hand-off are illegal in a capture, and an
    outer guard already covers a nested call)."""
    if getattr(_guard_tls, "inside", False) or (
        device.type == "cuda" and torch.cuda.is_current_stream_capturing()
    ):
        return launch()
    from .chaos.plane import chaos_site
    from .resilience.breaker import breaker_for, forced_open
    from .resilience.errors import KernelDeadlineExceeded, KernelUnavailable
    from .resilience.watchdog import abandoned, global_executor
    from .utils.metrics import global_metrics

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
    return out


def guarded(name: str):
    """Decorator form of ``guarded_call`` for a kernel wrapper whose first
    argument (or ``capacity``) is a tensor on the call's device. The
    decorated function is the module's wrapper: its counters
    (``launches``, ``forms``) are set on it."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            first = args[0] if args else kwargs["capacity"]
            return guarded_call(name, first.device, lambda: fn(*args, **kwargs))

        return call

    return wrap


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
