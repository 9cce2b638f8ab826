"""Telemetry-driven calibration plane: learned throughputs, probe-derived
admission thresholds, and constant provenance.

ROADMAP item 5 names two feedback loops that are pure software: Gavel
(arxiv 2008.09213) *assumes* known per-class throughput matrices, yet
the hetero policies (scheduler/hetero.py) run on hand-declared jobspec
coefficients; and the admission controller (server/admission.py) runs
on hand-set threshold constants even though ``saturation_search``
already measures the sustainable rate. This module closes both loops:

* :class:`ThroughputEstimator` — subscribes to the flight-recorder
  listener fan-out (the same seam ``SloCollector`` uses) and maintains
  online per-(device_class × job-profile) throughput estimates from
  observed execute spans: an EMA point estimate anchored by a
  :class:`LogHistogram` of raw rates, per-cell sample counts, and a
  confidence score. Starvation-safe: a cell below the sample floor
  answers with the DECLARED coefficient and reports ``source:
  default`` — estimation degrades to declared, never to garbage.
* :class:`CalibrationTable` — the registry every hand-set constant in
  admission and resilience now routes through. Each entry is a
  :class:`CalibrationConstant` carrying provenance ``{value, source:
  default|probe|learned, samples, window, updated_at_index}``. The
  NTA018 lint bans bare threshold literals outside this module, so a
  constant without provenance can't quietly reappear.
* :func:`derive_admission_thresholds` + the ``CALIB_r01.json`` probe
  artifact — ``bench.py soak --saturation`` persists the measured
  sustainable rate; loading the artifact rewrites the admission
  enter/exit backlog thresholds from Little's law (backlog = rate ×
  tolerated delay) with ``source: probe``.
* :func:`run_calib_ab` — the ``bench.py calib`` gate: rerun the hetero
  A/B with throughputs learned ONLINE from span telemetry (declared
  coefficients hidden from the policies) and require the Gavel wins to
  reproduce within tolerance of the declared run, with
  ``throughput_source=declared`` pinned bit-identical and zero added
  retraces (builds, ``analysis/retrace.py``).

Like ``flight_recorder`` and ``global_metrics`` there is one
process-global ``global_table`` / ``global_estimator`` pair; servers
and kernels share them so learned values observed through one seam are
visible at every other.

The port's copy differs from the JAX package's in one respect:
``run_calib_ab`` runs on ``device``. Its ``added_retraces`` counts the
port's "trace", a build a call starts (a library's first load, a new
Triton specialization; ``analysis/retrace.py``). The chaos site
``calib.telemetry_drop`` is live here, as in the reference.
"""

from __future__ import annotations

import json
import math
import threading
import time
from typing import Callable, Optional

import numpy as np

from ..chaos.plane import chaos_site
from ..utils.hist import LogHistogram
from ..utils.metrics import global_metrics

# -- provenance ---------------------------------------------------------------

SOURCE_DEFAULT = "default"
SOURCE_PROBE = "probe"
SOURCE_LEARNED = "learned"
SOURCES = (SOURCE_DEFAULT, SOURCE_PROBE, SOURCE_LEARNED)

#: canonical name of the persisted saturation-probe artifact
PROBE_ARTIFACT = "CALIB_r01.json"
_PROBE_KIND = "saturation_search"
_PROBE_VERSION = 1


class CalibrationConstant:
    """One tuned constant with provenance. ``default`` is the shipped
    value the entry can always be reset to; ``value`` is what consumers
    read; ``source`` says who set it."""

    __slots__ = ("name", "value", "default", "source", "samples", "window",
                 "updated_at_index")

    def __init__(self, name: str, default: float):
        self.name = name
        self.default = float(default)
        self.value = float(default)
        self.source = SOURCE_DEFAULT
        self.samples = 0
        self.window = ""
        self.updated_at_index = 0

    def to_dict(self) -> dict:
        return {
            "value": self.value,
            "default": self.default,
            "source": self.source,
            "samples": self.samples,
            "window": self.window,
            "updated_at_index": self.updated_at_index,
        }


# The shipped defaults, verbatim from the constants they replace:
# server/admission.py's _DEFAULTS and resilience/breaker.py's
# deadline defaults. This tuple is the ONE place bare threshold numbers
# are allowed to live (NTA018 exempts this module).
DEFAULT_CONSTANTS: tuple[tuple[str, float], ...] = (
    ("admission.brownout_backlog", 512.0),
    ("admission.shed_backlog", 2048.0),
    ("admission.brownout_p99_ms", 2500.0),
    ("admission.shed_p99_ms", 10000.0),
    ("admission.exit_fraction", 0.5),
    ("admission.imbalance_ratio", 1.5),
    ("admission.imbalance_min_backlog", 64.0),
    ("admission.min_p99_samples", 16),
    ("admission.dwell_s", 2.0),
    ("admission.reeval_interval_s", 0.25),
    ("admission.retry_after_s", 2.0),
    ("admission.defer_delay_s", 1.0),
    ("admission.flap_window_s", 0.4),
    ("admission.watermark_fraction.high", 1.0),
    ("admission.watermark_fraction.normal", 0.5),
    ("admission.watermark_fraction.low", 0.25),
    ("admission.brownout_batch_factor", 2),
    ("admission.brownout_batch_timeout_s", 0.4),
    ("admission.shed_cost_quantile", 0.5),
    ("resilience.execute_deadline_s", 5.0),
    ("resilience.compile_deadline_s", 60.0),
)


class CalibrationTable:
    """Thread-safe registry of :class:`CalibrationConstant`. Fixed key
    set (bounded by construction): every constant is declared in
    ``DEFAULT_CONSTANTS``; ``set`` on an unknown name raises."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries = {
            name: CalibrationConstant(name, default)
            for name, default in DEFAULT_CONSTANTS
        }
        self._index = 0
        self._probe: Optional[dict] = None

    def get(self, name: str) -> float:
        with self._lock:
            return self._entries[name].value

    def entry(self, name: str) -> dict:
        with self._lock:
            return self._entries[name].to_dict()

    def names(self) -> list[str]:
        with self._lock:
            return sorted(self._entries)

    def set(
        self,
        name: str,
        value: float,
        source: str = SOURCE_LEARNED,
        samples: int = 0,
        window: str = "",
    ) -> None:
        if source not in SOURCES:
            raise ValueError(f"unknown calibration source: {source!r}")
        value = float(value)
        if not math.isfinite(value):
            raise ValueError(f"non-finite calibration value for {name}: {value}")
        with self._lock:
            e = self._entries[name]  # KeyError on unknown = the contract
            self._index += 1
            e.value = value
            e.source = source
            e.samples = int(samples)
            e.window = window
            e.updated_at_index = self._index
            global_metrics.incr("nomad.calib.constant_updates")

    def reset(self) -> None:
        """Back to shipped defaults (test isolation for the globals)."""
        with self._lock:
            for e in self._entries.values():
                e.value = e.default
                e.source = SOURCE_DEFAULT
                e.samples = 0
                e.window = ""
                e.updated_at_index = 0
            self._index = 0
            self._probe = None

    def snapshot(self) -> dict:
        with self._lock:
            by_source: dict[str, int] = {s: 0 for s in SOURCES}
            constants = {}
            for name in sorted(self._entries):
                d = self._entries[name].to_dict()
                constants[name] = d
                by_source[d["source"]] += 1
            return {
                "constants": constants,
                "by_source": by_source,
                "probe": dict(self._probe) if self._probe else None,
            }

    # -- consumer views ---------------------------------------------------

    def admission_overrides(self) -> dict:
        """The table's values shaped as ``AdmissionController`` overrides
        — the dict that used to be admission's hand-set ``_DEFAULTS``."""
        with self._lock:
            v = {name: e.value for name, e in self._entries.items()}
        return {
            "brownout_backlog": v["admission.brownout_backlog"],
            "shed_backlog": v["admission.shed_backlog"],
            "brownout_p99_ms": v["admission.brownout_p99_ms"],
            "shed_p99_ms": v["admission.shed_p99_ms"],
            "exit_fraction": v["admission.exit_fraction"],
            "imbalance_ratio": v["admission.imbalance_ratio"],
            "imbalance_min_backlog": v["admission.imbalance_min_backlog"],
            "min_p99_samples": int(v["admission.min_p99_samples"]),
            "dwell_s": v["admission.dwell_s"],
            "reeval_interval_s": v["admission.reeval_interval_s"],
            "retry_after_s": v["admission.retry_after_s"],
            "defer_delay_s": v["admission.defer_delay_s"],
            "flap_window_s": v["admission.flap_window_s"],
            "watermark_fractions": {
                "high": v["admission.watermark_fraction.high"],
                "normal": v["admission.watermark_fraction.normal"],
                "low": v["admission.watermark_fraction.low"],
            },
            "brownout_batch_factor": int(v["admission.brownout_batch_factor"]),
            "brownout_batch_timeout_s": v["admission.brownout_batch_timeout_s"],
            "shed_cost_quantile": v["admission.shed_cost_quantile"],
        }

    def breaker_defaults(self) -> dict:
        """Deadline defaults for ``resilience/breaker.py`` (env vars keep
        precedence over the table at the breaker seam)."""
        with self._lock:
            return {
                "execute_deadline": self._entries[
                    "resilience.execute_deadline_s"
                ].value,
                "compile_deadline": self._entries[
                    "resilience.compile_deadline_s"
                ].value,
            }

    # -- probe artifact ---------------------------------------------------

    def load_probe_artifact(self, artifact) -> int:
        """Ingest a persisted saturation-probe artifact (a path or an
        already-parsed dict, see :func:`write_probe_artifact`) and derive
        the admission enter thresholds from the measured sustainable
        rate. Returns the number of constants rewritten."""
        if isinstance(artifact, (str, bytes)):
            with open(artifact, "r", encoding="utf-8") as f:
                artifact = json.load(f)
        if artifact.get("kind") != _PROBE_KIND:
            raise ValueError(
                f"not a saturation probe artifact: kind={artifact.get('kind')!r}"
            )
        rate = float(artifact["rate_evals_per_s"])
        if not (math.isfinite(rate) and rate > 0):
            raise ValueError(f"bad probed rate: {rate!r}")
        window = f"{float(artifact.get('probe_seconds', 0.0)):g}s"
        samples = int(artifact.get("samples", max(1, int(rate))))
        derived = derive_admission_thresholds(rate, table=self)
        for name, value in derived.items():
            self.set(name, value, source=SOURCE_PROBE, samples=samples,
                     window=window)
        with self._lock:
            self._probe = {
                "rate_evals_per_s": rate,
                "seed": artifact.get("seed"),
                "nodes": artifact.get("nodes"),
                "probe_seconds": artifact.get("probe_seconds"),
            }
        return len(derived)


def derive_admission_thresholds(
    rate_per_s: float, table: Optional[CalibrationTable] = None
) -> dict:
    """Backlog thresholds from a measured sustainable rate, via Little's
    law: a backlog of ``rate × T`` evals means an arriving eval already
    waits ``T`` seconds at the sustainable service rate — so enter
    brownout when the backlog implies the brownout p99 target is spent,
    and shed at the shed target. Floors keep tiny probe rates from
    collapsing the thresholds below useful hysteresis widths."""
    t = table if table is not None else global_table
    brownout_s = t.get("admission.brownout_p99_ms") / 1000.0
    shed_s = t.get("admission.shed_p99_ms") / 1000.0
    brownout_backlog = max(16.0, round(rate_per_s * brownout_s))
    shed_backlog = max(2.0 * brownout_backlog, round(rate_per_s * shed_s))
    # imbalance vote needs a real backlog behind it: an eighth of the
    # brownout point, floored where the shipped default floors
    imbalance_min = max(8.0, round(brownout_backlog / 8.0))
    return {
        "admission.brownout_backlog": float(brownout_backlog),
        "admission.shed_backlog": float(shed_backlog),
        "admission.imbalance_min_backlog": float(imbalance_min),
    }


def write_probe_artifact(
    path: str,
    rate_per_s: float,
    seed: int = 0,
    nodes: int = 0,
    probe_seconds: float = 0.0,
    samples: int = 0,
) -> dict:
    """Persist one ``saturation_search`` measurement as the canonical
    ``CALIB_r01.json`` shape (sorted keys — byte-reproducible for a
    given measurement)."""
    artifact = {
        "artifact": "CALIB_r01",
        "version": _PROBE_VERSION,
        "kind": _PROBE_KIND,
        "rate_evals_per_s": float(rate_per_s),
        "seed": int(seed),
        "nodes": int(nodes),
        "probe_seconds": float(probe_seconds),
        "samples": int(samples),
    }
    with open(path, "w", encoding="utf-8") as f:
        json.dump(artifact, f, indent=2, sort_keys=True)
        f.write("\n")
    return artifact


# -- online throughput estimation --------------------------------------------


class _Cell:
    __slots__ = ("ema", "samples", "hist", "updated_at_index", "updated_at")

    def __init__(self):
        self.ema = 0.0
        self.samples = 0
        self.hist = LogHistogram()
        self.updated_at_index = 0
        self.updated_at = 0.0


class ThroughputEstimator:
    """Online per-(device_class × job-profile) throughput estimates from
    the flight-recorder span stream.

    Input convention: any span whose tags carry ``device_class``,
    ``job_profile`` and ``work_units`` contributes one sample of
    ``work_units / duration_s`` to its cell. The EMA (seeded with the
    first sample so a constant stream converges exactly) is the point
    estimate; the per-cell :class:`LogHistogram` keeps the raw rate
    distribution for confidence/percentile reads.

    Reads go through :meth:`value`, which NEVER returns garbage: a cell
    below ``sample_floor`` answers with the caller's declared anchor
    (``source: default``), and a learned answer is clamped into
    ``[anchor/clamp_band, anchor×clamp_band]`` — invariant law 14
    (``calibration_sanity``) checks both properties.

    The chaos site ``calib.telemetry_drop`` drops input samples before
    they reach a cell, proving starvation degrades to declared.
    """

    def __init__(
        self,
        recorder=None,
        sample_floor: int = 8,
        clamp_band: float = 8.0,
        ema_alpha: float = 0.2,
        max_cells: int = 256,
        clock: Optional[Callable[[], float]] = None,
    ):
        if recorder is None:
            from .recorder import flight_recorder

            recorder = flight_recorder
        self._recorder = recorder
        self.sample_floor = int(sample_floor)
        self.clamp_band = float(clamp_band)
        self.ema_alpha = float(ema_alpha)
        self.max_cells = int(max_cells)
        self._clock = clock if clock is not None else time.monotonic
        self._lock = threading.Lock()
        # bounded by construction: at most max_cells (class × profile)
        # entries; overflow drops the sample and bumps a counter
        self._cells: dict[tuple[str, str], _Cell] = {}
        self._index = 0
        self._attached = 0
        self._dropped = 0
        self._overflow = 0

    # -- recorder seam ----------------------------------------------------

    def attach(self) -> None:
        """Idempotent, refcounted subscribe to the recorder fan-out."""
        with self._lock:
            self._attached += 1
            if self._attached == 1:
                self._recorder.add_listener(self._on_trace)

    def detach(self) -> None:
        with self._lock:
            if self._attached == 0:
                return
            self._attached -= 1
            if self._attached == 0:
                self._recorder.remove_listener(self._on_trace)

    def _on_trace(self, trace: dict) -> None:
        for span in trace.get("spans") or ():
            tags = span.get("tags") or {}
            cls = tags.get("device_class")
            profile = tags.get("job_profile")
            work = tags.get("work_units")
            if cls is None or profile is None or work is None:
                continue
            dur_ms = span.get("duration_ms")
            if not dur_ms or dur_ms <= 0:
                continue
            self.observe(str(cls), str(profile),
                         float(work) / (float(dur_ms) / 1000.0))

    # -- writes -----------------------------------------------------------

    def observe(self, device_class: str, profile: str, rate: float) -> None:
        """One throughput sample (work units per second) for a cell."""
        if not (math.isfinite(rate) and rate > 0):
            return
        if chaos_site("calib.telemetry_drop") == "drop":
            with self._lock:
                self._dropped += 1
            global_metrics.incr("nomad.calib.telemetry_dropped")
            return
        key = (device_class, profile)
        with self._lock:
            cell = self._cells.get(key)
            if cell is None:
                if len(self._cells) >= self.max_cells:
                    self._overflow += 1
                    global_metrics.incr("nomad.calib.cell_overflow")
                    return
                cell = self._cells[key] = _Cell()
            self._index += 1
            if cell.samples == 0:
                cell.ema = rate
            else:
                cell.ema += self.ema_alpha * (rate - cell.ema)
            cell.samples += 1
            cell.hist.record(rate)
            cell.updated_at_index = self._index
            cell.updated_at = self._clock()
        global_metrics.incr("nomad.calib.samples")

    def reset(self) -> None:
        with self._lock:
            self._cells.clear()
            self._index = 0
            self._dropped = 0
            self._overflow = 0

    # -- reads ------------------------------------------------------------

    def value(
        self, device_class: str, profile: str, declared: float = 1.0
    ) -> tuple[float, str]:
        """(throughput, source) for a cell. Starved or unknown cells
        answer the declared anchor; learned answers are clamped into the
        band around it so one wild window can't distort placement by
        more than ``clamp_band``×."""
        declared = float(declared)
        with self._lock:
            cell = self._cells.get((device_class, profile))
            if cell is None or cell.samples < self.sample_floor:
                return declared, SOURCE_DEFAULT
            ema = cell.ema
        if not (math.isfinite(ema) and ema > 0):
            return declared, SOURCE_DEFAULT
        anchor = declared if declared > 0 else 1.0
        lo, hi = anchor / self.clamp_band, anchor * self.clamp_band
        return min(max(ema, lo), hi), SOURCE_LEARNED

    def confidence(self, device_class: str, profile: str) -> float:
        """0 at no samples, 0.5 at the floor, → 1 with volume."""
        with self._lock:
            cell = self._cells.get((device_class, profile))
            samples = cell.samples if cell is not None else 0
        return samples / (samples + float(self.sample_floor))

    def cell_count(self) -> int:
        with self._lock:
            return len(self._cells)

    def snapshot(self) -> dict:
        """The estimator matrix + provenance (``/v1/agent/calibration``,
        law 14, the SLO calibration block)."""
        with self._lock:
            cells = {}
            total = 0
            learned = 0
            for (cls, profile), cell in sorted(self._cells.items()):
                is_learned = cell.samples >= self.sample_floor
                learned += 1 if is_learned else 0
                total += cell.samples
                cells[f"{cls}|{profile}"] = {
                    "device_class": cls,
                    "profile": profile,
                    "ema": cell.ema,
                    "samples": cell.samples,
                    "confidence": cell.samples
                    / (cell.samples + float(self.sample_floor)),
                    "source": SOURCE_LEARNED if is_learned else SOURCE_DEFAULT,
                    "p50": cell.hist.percentile(0.50),
                    "updated_at_index": cell.updated_at_index,
                }
            return {
                "cells": cells,
                "cell_count": len(cells),
                "learned_cells": learned,
                "samples": total,
                "sample_floor": self.sample_floor,
                "clamp_band": self.clamp_band,
                "dropped": self._dropped,
                "overflow": self._overflow,
            }


def learned_tp_matrix(estimator, ct, asks, declared_tp: np.ndarray) -> np.ndarray:
    """Substitute learned per-class throughputs into a hetero batch's
    declared tp matrix (f32[G, N] in, f32[G, N] out — same shape/dtype,
    so the hetero kernel is launched exactly as in declared mode).
    Only asks carrying a calibration ``profile`` are substituted; each
    cell falls back to its declared anchor below the sample floor."""
    ids, vocab = ct.device_class_column()
    ids = np.asarray(ids)
    out = np.array(declared_tp, dtype=np.float32, copy=True)
    first_row = {
        cid: int(w[0])
        for cid, w in (
            (cid, np.flatnonzero(ids == cid)) for cid in vocab.values()
        )
        if w.size
    }
    for i, a in enumerate(asks):
        profile = getattr(a, "profile", "") or ""
        if not profile:
            continue
        per_class = np.ones(len(vocab), dtype=np.float32)
        for name, cid in vocab.items():
            row = first_row.get(cid)
            anchor = float(declared_tp[i, row]) if row is not None else 1.0
            v, _src = estimator.value(name, profile, declared=anchor)
            per_class[cid] = np.float32(v)
        out[i] = per_class[ids]
    return out


# -- process-global instances -------------------------------------------------

global_table = CalibrationTable()
global_estimator = ThroughputEstimator()


def calibration_overview(table=None, estimator=None) -> dict:
    """The flat scalar block the SLO report embeds (schema-pinned)."""
    t = table if table is not None else global_table
    e = estimator if estimator is not None else global_estimator
    ts = t.snapshot()
    es = e.snapshot()
    return {
        "constants": len(ts["constants"]),
        "probe_sourced": ts["by_source"][SOURCE_PROBE],
        "learned_cells": es["learned_cells"],
        "estimator_samples": es["samples"],
    }


# -- the bench.py calib A/B gate ---------------------------------------------


def _profile_of(job_index: int) -> str:
    """The synthetic profile key for build_mixed_asks' three job kinds."""
    return f"kind{job_index % 3}"


def synth_execute_trace(
    trace_id: str, device_class: str, profile: str, work_units: float,
    duration_ms: float,
) -> dict:
    """A minimal flight-recorder trace carrying one estimator input
    span — the synthetic telemetry shape tests and the calib bench feed
    through the REAL listener fan-out."""
    return {
        "trace_id": trace_id,
        "eval_id": trace_id,
        "status": "ok",
        "started_at": 0.0,
        "duration_ms": duration_ms,
        "tags": {"priority": 50},
        "spans": [
            {
                "span_id": f"{trace_id}-s0",
                "parent_id": None,
                "name": "execute",
                "start_unix": 0.0,
                "duration_ms": duration_ms,
                "status": "ok",
                "tags": {
                    "device_class": device_class,
                    "job_profile": profile,
                    "work_units": work_units,
                },
            }
        ],
    }


def _blind_asks(asks) -> list:
    """Strip declared coefficients, keep only the profile key — what the
    policies see in learned mode (declared hidden from them)."""
    import copy

    out = []
    for j, a in enumerate(asks):
        b = copy.copy(a)
        b.throughputs = None
        b.has_throughputs = False
        b.profile = _profile_of(j)
        out.append(b)
    return out


def run_calib_ab(
    n_nodes: int = 1000,
    n_jobs: int = 12,
    count_per_job: int = 25,
    seed: int = 42,
    samples_per_cell: int = 24,
    tolerance: float = 0.25,
    device="cuda",
) -> dict:
    """The ``bench.py calib`` block: the hetero A/B rerun with
    throughputs learned ONLINE from span telemetry.

    Declared coefficients are hidden from the policies (asks carry only
    a profile key); the estimator learns each (class × profile) cell
    from synthetic execute spans fed through a real FlightRecorder
    fan-out whose per-sample rates carry deterministic jitter around the
    true coefficient. Gate: the learned run must reproduce the hetero
    wins (maxmin worst-share lift, makespan reduction) within
    ``tolerance`` of the declared run, the declared mode must stay
    byte-identical with the estimator in the room, and the learned run
    must start no build beyond the declared run's. Every pass runs on
    ``device``."""
    from ..analysis import retrace
    from ..backend import resolve_device
    from ..device.score import PlacementKernel
    from ..scheduler.hetero import (
        HeteroPlacementKernel,
        _quality_metrics,
        build_mixed_asks,
        build_mixed_fleet,
        run_hetero_ab,
    )
    from .recorder import FlightRecorder

    dev = resolve_device(device)
    declared_report = run_hetero_ab(
        n_nodes, n_jobs, count_per_job, seed, device=dev
    )

    ct = build_mixed_fleet(n_nodes, seed=seed)
    asks = build_mixed_asks(ct, n_jobs, count_per_job, seed=seed + 1)
    ids_arr, vocab = ct.device_class_column()
    ids_arr = np.asarray(ids_arr)
    class_names = sorted(k for k in vocab if k)

    # ground truth straight from the declared vectors about to be hidden:
    # the per-class coefficient of each job kind is what the synthetic
    # telemetry encodes and the estimator must recover
    maps = []
    for kind in range(min(3, n_jobs)):
        m = {}
        for name, cid in vocab.items():
            if not name:
                continue
            rows = np.flatnonzero(ids_arr == cid)
            if rows.size and asks[kind].throughputs is not None:
                m[name] = float(asks[kind].throughputs[rows[0]])
        maps.append(m)

    # learn online: dedicated recorder so the stream is exactly the
    # synthetic telemetry, fed through the production fan-out seam
    recorder = FlightRecorder()
    estimator = ThroughputEstimator(recorder=recorder, clock=lambda: 0.0)
    estimator.attach()
    n_traces = 0
    for kind, m in enumerate(maps):
        profile = f"kind{kind}"
        for cls in class_names:
            coeff = m.get(cls, 1.0)
            for k in range(samples_per_cell):
                # ±10% deterministic jitter: the estimator sees noisy
                # rates, never the coefficient itself
                jitter = 1.0 + 0.1 * math.sin(float(2 * k + kind))
                recorder.record(
                    synth_execute_trace(
                        f"calib-{profile}-{cls}-{k}", cls, profile,
                        work_units=coeff * jitter, duration_ms=1000.0,
                    )
                )
                n_traces += 1
    estimator.detach()

    blind = _blind_asks(asks)
    retrace_before = dict(retrace.counts())

    base = PlacementKernel("binpack", device=dev)
    base_results = base.place(ct, asks)
    report: dict = {
        "config": {
            "nodes": n_nodes,
            "jobs": n_jobs,
            "count_per_job": count_per_job,
            "seed": seed,
            "samples_per_cell": samples_per_cell,
            "tolerance": tolerance,
            "traces_fed": n_traces,
            "device_classes": class_names,
        },
        "estimator": estimator.snapshot(),
        "binpack": _quality_metrics(ct, asks, base_results),
        "policies": {},
    }

    declared_identical = True
    for policy in ("maxmin", "makespan", "cost"):
        learned_kern = HeteroPlacementKernel(
            policy, throughput_source="learned", estimator=estimator,
            device=dev,
        )
        learned_results = learned_kern.place(ct, blind)
        # score quality against the TRUE declared coefficients — the
        # policies never saw them, so recovered wins are real
        metrics = _quality_metrics(ct, asks, learned_results)
        report["policies"][f"hetero-{policy}"] = metrics

        # declared-mode pin: same kernel class, estimator in the room,
        # throughput_source=declared — placements must be byte-identical
        # to a pre-calibration kernel's
        plain = HeteroPlacementKernel(policy, device=dev).place(ct, asks)
        pinned = HeteroPlacementKernel(
            policy, throughput_source="declared", estimator=estimator,
            device=dev,
        ).place(ct, asks)
        for r0, r1 in zip(plain, pinned):
            if (
                r0.node_rows.tobytes() != r1.node_rows.tobytes()
                or r0.scores.tobytes() != r1.scores.tobytes()
            ):
                declared_identical = False

    retrace_after = dict(retrace.counts())
    added_retraces = sum(
        retrace_after.get(k, 0) - retrace_before.get(k, 0)
        for k in retrace_after
    )

    b = report["binpack"]
    mm = report["policies"]["hetero-maxmin"]
    ms = report["policies"]["hetero-makespan"]
    learned_ab = {
        "maxmin_worst_share_delta": round(mm["worst_share"] - b["worst_share"], 4),
        "makespan_delta": round(b["makespan"] - ms["makespan"], 4),
        "maxmin_improves_worst_share": mm["worst_share"] > b["worst_share"],
        "makespan_reduced": ms["makespan"] < b["makespan"],
    }
    declared_ab = declared_report["ab"]

    def _within(learned: float, declared: float) -> bool:
        return abs(learned - declared) <= tolerance * max(abs(declared), 1e-9)

    report["ab"] = {
        "declared": declared_ab,
        "learned": learned_ab,
        "worst_share_within_tolerance": _within(
            learned_ab["maxmin_worst_share_delta"],
            declared_ab["maxmin_worst_share_delta"],
        ),
        "makespan_within_tolerance": _within(
            learned_ab["makespan_delta"], declared_ab["makespan_delta"]
        ),
    }
    report["declared_mode_identical"] = declared_identical
    report["added_retraces"] = added_retraces
    report["ok"] = (
        declared_report["ok"]
        and learned_ab["maxmin_improves_worst_share"]
        and learned_ab["makespan_reduced"]
        and report["ab"]["worst_share_within_tolerance"]
        and report["ab"]["makespan_within_tolerance"]
        and declared_identical
        and added_retraces == 0
    )
    return report
