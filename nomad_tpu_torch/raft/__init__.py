"""Raft — the replicated-log backbone of the control plane.

``InlineRaft`` is the single-server path: serialized append → apply with
optional WAL durability (``nomad_tpu_torch.native``) and replay on boot;
the FSM is ``nomad_tpu_torch.server.fsm``. Full consensus (``RaftNode``:
election, replication, snapshot install) is not ported yet (ROADMAP A18).
"""

from .inline import InlineRaft

__all__ = ["InlineRaft"]
