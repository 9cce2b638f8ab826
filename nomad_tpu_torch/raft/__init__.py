"""Raft consensus — the replicated-log backbone of the control plane.

Reference: hashicorp/raft wired in nomad/server.go:105-109 with the
raft-boltdb log store and the FSM in nomad/fsm.go. Here the log rides the
native C++ WAL (nomad_tpu_torch.native), RPCs ride nomad_tpu_torch.rpc,
and the FSM is nomad_tpu_torch.server.fsm.

Two implementations share the contract:
- ``InlineRaft`` — the single-server fast path (dev agent): serialized
  append→apply with optional WAL durability and replay-on-boot.
- ``RaftNode`` — full consensus: leader election, log replication,
  commitment, snapshot install, membership-static peer set.
"""

from .inline import InlineRaft
from .node import NotLeaderError, RaftNode

__all__ = ["InlineRaft", "RaftNode", "NotLeaderError"]
