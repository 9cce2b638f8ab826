"""Device layer: cluster flattening + placement and score kernels."""

from .flatten import (
    ClusterTensors,
    GroupAsk,
    ValueBlocks,
    flatten_cluster,
    flatten_group_ask,
)
from .score import (
    PlacementKernel,
    PlacementResult,
    place_closed_form,
    repair_batch_conflicts,
    score_matrix,
)

__all__ = [
    "ClusterTensors",
    "GroupAsk",
    "ValueBlocks",
    "flatten_cluster",
    "flatten_group_ask",
    "PlacementKernel",
    "PlacementResult",
    "place_closed_form",
    "repair_batch_conflicts",
    "score_matrix",
]
