"""Cross-cutting helpers (metrics, ids)."""

from .metrics import Metrics, global_metrics

__all__ = ["Metrics", "global_metrics"]
