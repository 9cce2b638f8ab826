"""Span tracing, placement explanations, the flight recorder and the
calibration plane for the port."""

from .recorder import FlightRecorder, flight_recorder, phase_breakdown, trace_latencies
from .trace import Span, SpanContext, Tracer, global_tracer

__all__ = [
    "FlightRecorder",
    "Span",
    "SpanContext",
    "Tracer",
    "flight_recorder",
    "global_tracer",
    "phase_breakdown",
    "trace_latencies",
]
