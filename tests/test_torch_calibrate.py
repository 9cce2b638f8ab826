"""The port's calibration plane (``obs/calibrate.py``), its flight
recorder (``obs/recorder.py``) and learned-throughput hetero placement,
against the JAX reference, on the CPU.

Ports the cases of ``tests/test_calibrate.py`` that need no server,
admission or breaker module (those come with ROADMAP A9 / A14):
estimator convergence, the sample floor, clamps, the recorder fan-out
and its refcounted attach, the ``calib.telemetry_drop`` chaos site,
table provenance, the Little's-law derivation and the probe artifact's
round trip, the throughput-source seam and ``learned_tp_matrix``'s
anchors. Beside them, each package against the other:

- declared mode is bit-identical with an estimator attached, and equal
  to the reference's placements;
- from the same synthetic execute traces fed through each package's
  recorder fan-out, learned-mode hetero placements equal the
  reference's (node rows and uint32 scores);
- ``run_calib_ab`` passes its gate at a small size, and its report
  equals the reference's less ``added_retraces`` (a jaxpr retrace count,
  which the port leaves out until ROADMAP A17);
- the recorder's feeds: the tracer hands completed traces to the flight
  recorder, ``count_swallowed`` rings its error, and a Harness eval rings
  its explanations.

Tolerance: everything exact (estimator values with ``pytest.approx`` as
the reference's own tests use; placements and reports bit for bit).
"""

import json
import math

import numpy as np
import pytest

from nomad_tpu.obs import calibrate as ref_calibrate
from nomad_tpu.obs.recorder import FlightRecorder as RefRecorder
from nomad_tpu.scheduler import hetero as ref_hetero
from nomad_tpu_torch.obs.calibrate import (
    DEFAULT_CONSTANTS,
    CalibrationTable,
    ThroughputEstimator,
    calibration_overview,
    derive_admission_thresholds,
    global_estimator,
    learned_tp_matrix,
    run_calib_ab,
    synth_execute_trace,
    write_probe_artifact,
)
from nomad_tpu_torch.obs.recorder import FlightRecorder
from nomad_tpu_torch.scheduler import hetero as port_hetero
from test_torch_hetero import (
    _port_asks,
    _port_cluster,
    assert_bits_equal,
    reference_runtime,
)


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, dt: float) -> float:
        self.t += dt
        return self.t


def fed_estimator(n: int = 24, rate: float = 4.0, **kw):
    est = ThroughputEstimator(recorder=FlightRecorder(), **kw)
    for _ in range(n):
        est.observe("tpu-v4", "kind0", rate)
    return est


# -- throughput estimator ----------------------------------------------------


class TestEstimator:
    def test_constant_stream_converges_exactly(self):
        est = fed_estimator(n=24, rate=4.0)
        v, src = est.value("tpu-v4", "kind0", declared=1.0)
        assert src == "learned"
        assert v == pytest.approx(4.0)

    def test_noisy_stream_converges_near_truth(self):
        est = ThroughputEstimator(recorder=FlightRecorder())
        for k in range(64):
            est.observe("cpu", "kind2", 0.5 * (1.0 + 0.1 * math.sin(k)))
        v, src = est.value("cpu", "kind2", declared=1.0)
        assert src == "learned"
        assert v == pytest.approx(0.5, rel=0.15)

    def test_sample_floor_answers_declared(self):
        est = fed_estimator(n=7)  # floor is 8
        assert est.value("tpu-v4", "kind0", declared=2.5) == (2.5, "default")
        est.observe("tpu-v4", "kind0", 4.0)
        _, src = est.value("tpu-v4", "kind0", declared=2.5)
        assert src == "learned"

    def test_unknown_cell_answers_declared(self):
        est = ThroughputEstimator(recorder=FlightRecorder())
        assert est.value("gpu-a100", "kind1", declared=3.5) == (3.5, "default")

    def test_clamp_band_bounds_learned_answers(self):
        est = fed_estimator(n=24, rate=1000.0, clamp_band=8.0)
        assert est.value("tpu-v4", "kind0", declared=1.0) == (8.0, "learned")
        est2 = fed_estimator(n=24, rate=0.0001, clamp_band=8.0)
        v2, _ = est2.value("tpu-v4", "kind0", declared=1.0)
        assert v2 == pytest.approx(1.0 / 8.0)

    def test_rejects_garbage_samples(self):
        est = ThroughputEstimator(recorder=FlightRecorder())
        for bad in (0.0, -1.0, float("nan"), float("inf")):
            est.observe("cpu", "kind0", bad)
        assert est.cell_count() == 0

    def test_max_cells_bounds_accumulation(self):
        est = ThroughputEstimator(recorder=FlightRecorder(), max_cells=4)
        for i in range(10):
            est.observe(f"class-{i}", "kind0", 1.0)
        assert est.cell_count() == 4
        assert est.snapshot()["overflow"] == 6

    def test_confidence_monotone(self):
        est = ThroughputEstimator(recorder=FlightRecorder())
        assert est.confidence("cpu", "kind0") == 0.0
        for _ in range(8):
            est.observe("cpu", "kind0", 1.0)
        assert est.confidence("cpu", "kind0") == pytest.approx(0.5)
        for _ in range(100):
            est.observe("cpu", "kind0", 1.0)
        assert est.confidence("cpu", "kind0") > 0.9

    def test_clock_threads_through_fakeclock(self):
        clock = FakeClock()
        est = ThroughputEstimator(recorder=FlightRecorder(), clock=clock)
        est.observe("cpu", "kind0", 1.0)
        clock.advance(10.0)
        est.observe("cpu", "kind0", 1.0)
        assert est._cells[("cpu", "kind0")].updated_at == clock.t

    def test_snapshot_equals_reference_on_the_same_samples(self):
        """Same samples, same snapshot (cells, EMA, counts, sources)."""
        port = ThroughputEstimator(recorder=FlightRecorder(), clock=lambda: 0.0)
        ref = ref_calibrate.ThroughputEstimator(
            recorder=RefRecorder(), clock=lambda: 0.0
        )
        for k in range(40):
            for cls in ("tpu-v4", "cpu"):
                rate = (2.0 if cls == "cpu" else 5.0) * (1 + 0.1 * math.sin(k))
                port.observe(cls, f"kind{k % 3}", rate)
                ref.observe(cls, f"kind{k % 3}", rate)
        assert port.snapshot() == ref.snapshot()


class TestRecorderFeed:
    def test_execute_spans_feed_cells_via_fanout(self):
        rec = FlightRecorder()
        est = ThroughputEstimator(recorder=rec)
        est.attach()
        try:
            for k in range(12):
                rec.record(synth_execute_trace(
                    f"t{k}", "tpu-v4", "kind0",
                    work_units=4.0, duration_ms=1000.0,
                ))
        finally:
            est.detach()
        v, src = est.value("tpu-v4", "kind0", declared=1.0)
        assert (v, src) == (pytest.approx(4.0), "learned")

    def test_untagged_spans_are_ignored(self):
        rec = FlightRecorder()
        est = ThroughputEstimator(recorder=rec)
        est.attach()
        try:
            rec.record({
                "eval_id": "plain", "status": "acked", "started_at": 0.0,
                "duration_ms": 5.0, "tags": {},
                "spans": [{
                    "span_id": 1, "parent_id": None, "name": "dequeue",
                    "start_unix": 0.0, "duration_ms": 5.0,
                    "status": "ok", "tags": {},
                }],
            })
        finally:
            est.detach()
        assert est.cell_count() == 0

    def test_attach_is_refcounted(self):
        rec = FlightRecorder()
        est = ThroughputEstimator(recorder=rec)
        est.attach()
        est.attach()
        est.detach()
        assert est._on_trace in rec._listeners
        est.detach()
        assert est._on_trace not in rec._listeners

    def test_chaos_telemetry_drop_starves_cell_to_declared(self):
        from nomad_tpu_torch.chaos.plane import (
            FaultPlane,
            FaultSpec,
            install,
            uninstall,
        )

        est = ThroughputEstimator(recorder=FlightRecorder())
        plane = FaultPlane(schedule=[
            FaultSpec("calib.telemetry_drop", i, "drop") for i in range(6)
        ])
        install(plane)
        try:
            for _ in range(10):
                est.observe("tpu-v4", "kind0", 4.0)
        finally:
            uninstall()
        assert est.snapshot()["dropped"] == 6
        assert est.value("tpu-v4", "kind0", declared=1.5) == (1.5, "default")

    def test_tracer_feeds_the_flight_recorder(self):
        from nomad_tpu_torch.obs.recorder import flight_recorder
        from nomad_tpu_torch.obs.trace import global_tracer

        assert global_tracer.recorder is flight_recorder
        seen = []
        flight_recorder.add_listener(seen.append)
        try:
            global_tracer.begin("calib-feed-eval")
            with global_tracer.activate("calib-feed-eval"):
                with global_tracer.span("execute", tags={"work_units": 1.0}):
                    pass
            global_tracer.finish("calib-feed-eval")
        finally:
            flight_recorder.remove_listener(seen.append)
        assert [t["eval_id"] for t in seen] == ["calib-feed-eval"]
        assert flight_recorder.get("calib-feed-eval") is not None

    def test_count_swallowed_rings_the_error(self):
        from nomad_tpu_torch.obs.recorder import flight_recorder
        from nomad_tpu_torch.utils.metrics import count_swallowed, global_metrics

        before = global_metrics.snapshot()["counters"].get(
            "calibtest.swallowed_errors", 0
        )
        count_swallowed("calibtest", ValueError("boom"))
        after = global_metrics.snapshot()["counters"]["calibtest.swallowed_errors"]
        assert after == before + 1
        newest = flight_recorder.errors()[0]
        assert newest["component"] == "calibtest"
        assert "boom" in newest["error"]

    def test_harness_eval_rings_its_explanations(self):
        from nomad_tpu_torch import mock
        from nomad_tpu_torch.obs.recorder import flight_recorder
        from nomad_tpu_torch.scheduler import Harness
        from nomad_tpu_torch.state import StateStore

        store = StateStore()
        for i in range(6):
            store.upsert_node(1 + i, mock.node())
        job = mock.job()
        job.task_groups[0].count = 3
        h = Harness(store, device="cpu")
        store.upsert_job(h.next_index(), job)
        ev = mock.eval_for(job)
        store.upsert_evals(h.next_index(), [ev])
        h.process(ev)
        rec = flight_recorder.explanation(ev.id)
        assert rec is not None and rec["job_id"] == job.id
        assert set(rec["groups"]) == {"web"}


# -- calibration table -------------------------------------------------------


class TestCalibrationTable:
    def test_defaults_match_shipped_constants(self):
        t = CalibrationTable()
        for name, default in DEFAULT_CONSTANTS:
            e = t.entry(name)
            assert e["value"] == float(default)
            assert e["source"] == "default"
        assert DEFAULT_CONSTANTS == ref_calibrate.DEFAULT_CONSTANTS

    def test_set_records_provenance(self):
        t = CalibrationTable()
        t.set("admission.brownout_backlog", 128.0, source="probe",
              samples=40, window="2s")
        e = t.entry("admission.brownout_backlog")
        assert e["source"] == "probe"
        assert e["samples"] == 40
        assert e["window"] == "2s"
        assert e["updated_at_index"] == 1
        assert e["default"] == 512.0

    def test_set_rejects_unknown_name_and_garbage(self):
        t = CalibrationTable()
        with pytest.raises(KeyError):
            t.set("admission.not_a_constant", 1.0)
        with pytest.raises(ValueError):
            t.set("admission.brownout_backlog", float("nan"))
        with pytest.raises(ValueError):
            t.set("admission.brownout_backlog", 1.0, source="vibes")

    def test_views_equal_reference(self):
        port, ref = CalibrationTable(), ref_calibrate.CalibrationTable()
        assert port.admission_overrides() == ref.admission_overrides()
        assert port.breaker_defaults() == ref.breaker_defaults() == {
            "execute_deadline": 5.0, "compile_deadline": 60.0,
        }
        assert port.snapshot() == ref.snapshot()

    def test_reset_restores_defaults(self):
        t = CalibrationTable()
        t.set("admission.shed_backlog", 9.0, source="learned")
        t.reset()
        e = t.entry("admission.shed_backlog")
        assert (e["value"], e["source"]) == (2048.0, "default")


class TestProbeArtifact:
    def test_little_law_threshold_derivation(self):
        d = derive_admission_thresholds(100.0, table=CalibrationTable())
        assert d["admission.brownout_backlog"] == 250.0
        assert d["admission.shed_backlog"] == 1000.0
        assert d["admission.imbalance_min_backlog"] == 31.0

    def test_derivation_floors_tiny_rates(self):
        d = derive_admission_thresholds(1.0, table=CalibrationTable())
        assert d["admission.brownout_backlog"] == 16.0
        assert d["admission.shed_backlog"] == 32.0
        assert d["admission.imbalance_min_backlog"] == 8.0

    @pytest.mark.parametrize("rate", [0.5, 1.0, 37.5, 100.0, 4000.0])
    def test_derivation_equals_reference(self, rate):
        assert derive_admission_thresholds(
            rate, table=CalibrationTable()
        ) == ref_calibrate.derive_admission_thresholds(
            rate, table=ref_calibrate.CalibrationTable()
        )

    def test_write_then_load_roundtrip(self, tmp_path):
        path = tmp_path / "CALIB_r01.json"
        write_probe_artifact(
            str(path), rate_per_s=100.0, seed=7, nodes=200,
            probe_seconds=2.0, samples=40,
        )
        raw = path.read_text()
        assert raw == json.dumps(json.loads(raw), indent=2, sort_keys=True) + "\n"
        ref_path = tmp_path / "ref.json"
        ref_calibrate.write_probe_artifact(
            str(ref_path), rate_per_s=100.0, seed=7, nodes=200,
            probe_seconds=2.0, samples=40,
        )
        assert raw == ref_path.read_text()
        t = CalibrationTable()
        assert t.load_probe_artifact(str(path)) == 3
        e = t.entry("admission.brownout_backlog")
        assert (e["value"], e["source"], e["samples"], e["window"]) == (
            250.0, "probe", 40, "2s",
        )
        assert t.snapshot()["probe"]["rate_evals_per_s"] == 100.0
        assert t.snapshot()["by_source"]["probe"] == 3

    def test_load_rejects_wrong_kind_and_bad_rate(self):
        t = CalibrationTable()
        with pytest.raises(ValueError):
            t.load_probe_artifact({"kind": "not_a_probe"})
        with pytest.raises(ValueError):
            t.load_probe_artifact(
                {"kind": "saturation_search", "rate_evals_per_s": -1.0}
            )


def test_overview_reads_given_table_and_estimator():
    t = CalibrationTable()
    t.set("admission.shed_backlog", 100.0, source="probe")
    est = fed_estimator()
    assert calibration_overview(t, est) == {
        "constants": len(DEFAULT_CONSTANTS),
        "probe_sourced": 1,
        "learned_cells": 1,
        "estimator_samples": 24,
    }


# -- the throughput-source seam -----------------------------------------------


def _fleet(n_nodes=64, n_jobs=6, count=4, seed=9):
    ct = ref_hetero.build_mixed_fleet(n_nodes, seed=seed)
    return ct, ref_hetero.build_mixed_asks(
        ct, n_jobs=n_jobs, count_per_job=count, seed=seed
    )


def _traces(ct, asks):
    """Synthetic execute traces for each (class × kind) cell: the
    coefficient the job kind declares, with ±10% deterministic jitter
    (``run_calib_ab``'s recipe)."""
    ids, vocab = ct.device_class_column()
    ids = np.asarray(ids)
    out = []
    for kind in range(3):
        for name, cid in sorted(vocab.items()):
            rows = np.flatnonzero(ids == cid)
            if not name or not rows.size:
                continue
            coeff = float(asks[kind].throughputs[rows[0]])
            for k in range(12):
                jitter = 1.0 + 0.1 * math.sin(float(2 * k + kind))
                out.append(synth_execute_trace(
                    f"t-{kind}-{name}-{k}", name, f"kind{kind}",
                    work_units=coeff * jitter, duration_ms=1000.0,
                ))
    return out


def _learned_estimators(traces):
    port_rec, ref_rec = FlightRecorder(), RefRecorder()
    port = ThroughputEstimator(recorder=port_rec, clock=lambda: 0.0)
    ref = ref_calibrate.ThroughputEstimator(recorder=ref_rec, clock=lambda: 0.0)
    port.attach()
    ref.attach()
    for t in traces:
        port_rec.record(dict(t))
        ref_rec.record(dict(t))
    port.detach()
    ref.detach()
    return port, ref


class TestThroughputSourceSeam:
    def test_unknown_source_rejected(self):
        with pytest.raises(ValueError):
            port_hetero.HeteroPlacementKernel(
                "maxmin", throughput_source="psychic", device="cpu"
            )

    @pytest.mark.parametrize("policy", ["maxmin", "makespan", "cost"])
    def test_declared_mode_is_byte_identical_with_estimator_attached(
        self, policy, monkeypatch
    ):
        ct, asks = _fleet()
        pct, pasks = _port_cluster(ct), _port_asks(asks)
        est = fed_estimator()
        plain = port_hetero.HeteroPlacementKernel(policy, device="cpu").place(
            pct, pasks
        )
        pinned = port_hetero.HeteroPlacementKernel(
            policy, throughput_source="declared", estimator=est, device="cpu"
        ).place(pct, pasks)
        with reference_runtime(monkeypatch):
            ref = ref_hetero.HeteroPlacementKernel(policy).place(ct, asks)
        for r0, r1, rr in zip(plain, pinned, ref):
            assert r0.node_rows.tobytes() == r1.node_rows.tobytes()
            assert r0.scores.tobytes() == r1.scores.tobytes()
            assert r0.node_rows.tobytes() == rr.node_rows.tobytes()
            assert r0.scores.tobytes() == rr.scores.tobytes()

    def test_learned_matrix_preserves_shape_dtype_and_anchors(self):
        ct, asks = _fleet()
        pct, pasks = _port_cluster(ct), _port_asks(asks)
        for j, a in enumerate(pasks):
            a.profile = f"kind{j % 3}"
        batch = port_hetero.build_hetero_batch(pct, pasks)
        est = ThroughputEstimator(recorder=FlightRecorder())
        out = learned_tp_matrix(est, pct, pasks, batch.tp)
        assert out.shape == batch.tp.shape and out.dtype == batch.tp.dtype
        np.testing.assert_array_equal(out, batch.tp)

    def test_learned_matrix_equals_reference(self):
        ct, asks = _fleet()
        pct, pasks = _port_cluster(ct), _port_asks(asks)
        for a in list(asks) + list(pasks):
            a.profile = "kindX"
        ids, vocab = ct.device_class_column()
        cls_name = next(
            n for n in vocab if n and np.any(np.asarray(ids) == vocab[n])
        )
        port_est = ThroughputEstimator(recorder=FlightRecorder())
        ref_est = ref_calibrate.ThroughputEstimator(recorder=RefRecorder())
        for _ in range(24):
            port_est.observe(cls_name, "kindX", 2.0)
            ref_est.observe(cls_name, "kindX", 2.0)
        tp = port_hetero.build_hetero_batch(pct, pasks).tp
        got = learned_tp_matrix(port_est, pct, pasks, tp)
        want = ref_calibrate.learned_tp_matrix(ref_est, ct, asks, tp)
        assert_bits_equal([got], [want])
        rows = np.flatnonzero(np.asarray(ids) == vocab[cls_name])
        assert float(got[0, rows[0]]) == pytest.approx(2.0)

    @pytest.mark.parametrize("policy", ["maxmin", "makespan", "cost"])
    def test_learned_placements_equal_reference(self, policy, monkeypatch):
        """The same synthetic execute traces through each package's
        recorder fan-out; asks blinded (declared coefficients hidden, a
        profile key kept); learned-mode placements bit for bit."""
        ct, asks = _fleet(n_nodes=96, n_jobs=6, count=6, seed=4)
        port_est, ref_est = _learned_estimators(_traces(ct, asks))
        assert port_est.snapshot() == ref_est.snapshot()
        ref_blind = ref_calibrate._blind_asks(asks)
        from nomad_tpu_torch.obs.calibrate import _blind_asks

        port_blind = _blind_asks(_port_asks(asks))
        pct = _port_cluster(ct)
        got = port_hetero.HeteroPlacementKernel(
            policy, throughput_source="learned", estimator=port_est,
            device="cpu",
        ).place(pct, port_blind)
        with reference_runtime(monkeypatch):
            want = ref_hetero.HeteroPlacementKernel(
                policy, throughput_source="learned", estimator=ref_est
            ).place(ct, ref_blind)
        assert sum(int((r.node_rows >= 0).sum()) for r in got) > 0
        for g, w in zip(got, want):
            assert_bits_equal([g.node_rows, g.scores], [w.node_rows, w.scores])

    def test_learned_mode_without_profiles_delegates_to_binpack(self):
        """No declared coefficients and no profile key: the hetero pass
        has nothing to rank by and the base kernel places."""
        ct, asks = _fleet()
        pct = _port_cluster(ct)
        pasks = _port_asks(asks)
        for a in pasks:
            a.throughputs, a.has_throughputs, a.profile = None, False, ""
        kern = port_hetero.HeteroPlacementKernel(
            "maxmin", throughput_source="learned", estimator=fed_estimator(),
            device="cpu",
        )
        got = kern.place(pct, pasks)
        want = kern._base.place(pct, pasks)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.node_rows, w.node_rows)

    def test_wire_throughput_source(self):
        from nomad_tpu_torch.scheduler.generic import wire_throughput_source
        from nomad_tpu_torch.state.store import SchedulerConfiguration

        k = port_hetero.HeteroPlacementKernel("maxmin", device="cpu")
        wire_throughput_source(k, SchedulerConfiguration())
        assert k.throughput_source == "declared" and k.estimator is None
        wire_throughput_source(
            k, SchedulerConfiguration(throughput_source="learned")
        )
        assert k.throughput_source == "learned"
        assert k.estimator is global_estimator


# -- the calib A/B gate --------------------------------------------------------


class TestCalibAB:
    KW = dict(n_nodes=200, n_jobs=6, count_per_job=10, seed=42)

    @pytest.fixture(scope="class")
    def reports(self):
        port = run_calib_ab(**self.KW, device="cpu")
        with pytest.MonkeyPatch.context() as mp:
            with reference_runtime(mp):
                ref = ref_calibrate.run_calib_ab(**self.KW)
        return port, ref

    def test_gate_passes(self, reports):
        port, _ = reports
        assert port["ok"], port["ab"]
        assert port["declared_mode_identical"] is True

    def test_report_equals_reference_less_retraces(self, reports):
        """The port's report is the reference's without ``added_retraces``
        (an XLA retrace count; the port's compile counts are A17's)."""
        port, ref = reports
        assert "added_retraces" not in port
        assert ref.pop("added_retraces") == 0
        assert port == ref

    def test_estimator_learned_every_cell(self, reports):
        est = reports[0]["estimator"]
        assert est["learned_cells"] == est["cell_count"] > 0
        assert est["dropped"] == 0 and est["overflow"] == 0

    def test_report_is_canonical_json(self, reports):
        s = json.dumps(reports[0], sort_keys=True)
        assert json.loads(s) == json.loads(json.dumps(json.loads(s), sort_keys=True))
