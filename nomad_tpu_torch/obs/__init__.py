"""Span tracing and placement explanations for the port."""

from .trace import Span, SpanContext, Tracer, global_tracer

__all__ = ["Span", "SpanContext", "Tracer", "global_tracer"]
