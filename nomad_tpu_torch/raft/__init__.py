"""Raft — the replicated-log backbone of the control plane.

``InlineRaft`` is the single-server path: serialized append → apply with
optional WAL durability (``nomad_tpu_torch.native``) and replay on boot;
the FSM is ``nomad_tpu_torch.server.fsm``. ``NotLeaderError`` is the
error a consensus node raises on a follower. Full consensus (``RaftNode``:
election, replication, snapshot install) is not ported yet (ROADMAP A18b).
"""

from .inline import InlineRaft
from .node import NotLeaderError

__all__ = ["InlineRaft", "NotLeaderError"]
