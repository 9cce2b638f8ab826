"""Raft consensus node — for now only the error its callers catch.

``NotLeaderError`` is what a write to a follower raises; the HTTP API's
``DELETE /v1/operator/raft/peer`` answers it (reference
``raft/node.py:43-47``). ``RaftNode`` itself (leader election, log
replication, commitment, snapshot install) is not ported yet: it comes
with the server cluster and gossip in ROADMAP A18b. Until then the only
raft is the single-server ``InlineRaft``, which never raises this.
"""

from __future__ import annotations

from typing import Optional


class NotLeaderError(Exception):
    def __init__(self, leader_id: Optional[str], leader_addr: Optional[str]):
        super().__init__(f"not the leader (leader={leader_id})")
        self.leader_id = leader_id
        self.leader_addr = leader_addr
