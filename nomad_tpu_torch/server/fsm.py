"""FSM — typed, replicable state-mutation messages.

Reference: nomad/fsm.go — every cluster write is a ``structs.MessageType``
log entry applied by a registered applier (:62-73); the FSM is the ONLY
writer of the state store, so replaying the Raft log on any server
reproduces identical state. Here each message is (MsgType, payload dict of
plain structs, pickled in the log); appliers are deterministic functions
of (store state, payload, index).

Decision logic (validation, eval construction, plan evaluation) stays in
the endpoints/leader — exactly like the reference, where Job.Register
builds the request and the FSM only applies it.
"""

from __future__ import annotations

import logging
from enum import IntEnum
from typing import Any, Optional

log = logging.getLogger(__name__)


class MsgType(IntEnum):
    """nomad/structs MessageType analog (fsm.go:36-59)."""

    NOOP = 0                      # leadership-change barrier entries
    JOB_UPSERT = 1                # {job, evals}
    JOB_BATCH_GC = 2              # {eval_ids, alloc_ids, jobs, node_ids, deployment_ids}
    JOB_STABLE = 3                # {job}  (stable rollback target)
    NODE_UPSERT = 4               # {node}
    NODE_STATUS = 5               # {node_id, status}
    NODE_DRAIN = 6                # {node_id, drain, eligibility, transitions, evals}
    NODE_ELIGIBILITY = 7          # {node_id, eligibility}
    EVAL_UPSERT = 8               # {evals}
    ALLOC_CLIENT_UPDATE = 9       # {updates}
    ALLOC_DESIRED_TRANSITION = 10 # {transitions, evals}
    ALLOC_HEALTH = 11             # {healthy_ids, unhealthy_ids}
    PLAN_RESULT = 12              # {result, eval_id, evals}
    DEPLOYMENT_STATUS = 13        # {deployment_id, status, description}
    DEPLOYMENT_UPSERT = 14        # {deployment}
    CSI_VOLUME_UPSERT = 15        # {volume}
    CSI_VOLUME_DEREGISTER = 16    # {volume_id, force}
    CSI_CLAIM = 17                # {volume_id, claim_id, node_id, read_only}
    CSI_RELEASE = 18              # {volume_id, claim_id}
    ACL_BOOTSTRAP = 19            # {token}
    ACL_POLICY_UPSERT = 20        # {policies}
    ACL_POLICY_DELETE = 21        # {names}
    ACL_TOKEN_UPSERT = 22         # {tokens}
    ACL_TOKEN_DELETE = 23         # {accessor_ids}
    SCHED_CONFIG = 24             # {config}
    NAMESPACE_UPSERT = 25         # {namespace}
    NAMESPACE_DELETE = 26         # {name}
    JOB_SCALE = 27                # {job, evals, event}
    RAFT_REMOVE_PEER = 28         # {node_id} — membership change; the
                                  # raft layer consumes it (autopilot
                                  # dead-server cleanup, operator raft
                                  # remove-peer); no state-store effect
    MERGED_PLAN_RESULT = 29       # {results, eval_ids, evals} — one
                                  # batched pass's member PlanResults as
                                  # a single log entry / store txn


class FSM:
    """Applies committed log entries to the state store. ``store`` is
    swappable (snapshot restore installs a fresh store), so the FSM
    resolves it through a getter."""

    def __init__(self, get_store):
        self._get_store = get_store

    @property
    def store(self):
        return self._get_store()

    def apply(self, index: int, mtype: int, payload: Optional[dict]) -> Any:
        """Apply one committed entry; returns the applier's result (used by
        the submitting endpoint on the leader; followers discard it).
        Appliers must be deterministic — no wall-clock, no randomness."""
        try:
            handler = _APPLIERS[MsgType(mtype)]
        except (ValueError, KeyError):
            # Unknown message from a newer version: tolerate, don't crash
            # the FSM (fsm.go ignores with an error log for forward compat).
            log.error("fsm: unknown message type %s at index %d", mtype, index)
            self.store.bump_index(index)
            return None
        # Appliers must NEVER let an exception escape: the entry is already
        # durably logged/replicated, so raising would desync the index
        # sequence (poisoning WAL contiguity) and crash log replay on boot.
        # A rejection is a deterministic no-op + error result — identical
        # on every replica since it depends only on store state. (e.g. a
        # NODE_STATUS for a node that GC reaped between submit and apply.)
        try:
            result = handler(self, self.store, index, payload or {})
            # Some store ops no-op on rejection (csi_claim → False) without
            # touching indexes; latest_index MUST advance for every applied
            # entry or the next append desyncs from the log (bump is a max,
            # so this is free when the applier already bumped).
            self.store.bump_index(index)
            return result
        except Exception as e:  # noqa: BLE001 — invariant, see above
            log.warning(
                "fsm: applier %s rejected entry at index %d: %s",
                MsgType(mtype).name, index, e,
            )
            self.store.bump_index(index)
            return e


# -- appliers (fsm.go:62-73 LogAppliers table) ------------------------------

def _apply_noop(fsm, store, index, p):
    store.bump_index(index)


def _apply_job_upsert(fsm, store, index, p):
    store.upsert_job(index, p["job"])
    if p.get("evals"):
        for ev in p["evals"]:
            ev.job_modify_index = index
        store.upsert_evals(index, p["evals"])


def _apply_job_batch_gc(fsm, store, index, p):
    if p.get("eval_ids"):
        store.delete_evals(index, p["eval_ids"])
    if p.get("alloc_ids"):
        store.delete_allocs(index, p["alloc_ids"])
    for ns, job_id in p.get("jobs", ()):
        store.delete_job(index, ns, job_id)
    for node_id in p.get("node_ids", ()):
        store.delete_node(index, node_id)
    for dep_id in p.get("deployment_ids", ()):
        store.delete_deployment(index, dep_id)


def _apply_job_stable(fsm, store, index, p):
    store.mark_job_stable(index, p["job"])


def _apply_node_upsert(fsm, store, index, p):
    store.upsert_node(index, p["node"])


def _apply_node_status(fsm, store, index, p):
    store.update_node_status(index, p["node_id"], p["status"])


def _apply_node_drain(fsm, store, index, p):
    store.update_node_drain(
        index, p["node_id"], p.get("drain"),
        eligibility=p.get("eligibility"),
    )
    if p.get("transitions"):
        store.update_allocs_desired_transition(index, p["transitions"])
    if p.get("evals"):
        store.upsert_evals(index, p["evals"])


def _apply_node_eligibility(fsm, store, index, p):
    store.update_node_eligibility(index, p["node_id"], p["eligibility"])


def _apply_eval_upsert(fsm, store, index, p):
    store.upsert_evals(index, p["evals"])


def _apply_alloc_client_update(fsm, store, index, p):
    store.update_allocs_from_client(index, p["updates"])


def _apply_alloc_desired_transition(fsm, store, index, p):
    store.update_allocs_desired_transition(index, p["transitions"])
    if p.get("evals"):
        store.upsert_evals(index, p["evals"])


def _apply_alloc_health(fsm, store, index, p):
    store.update_alloc_health(
        index, p.get("healthy_ids", []), p.get("unhealthy_ids", [])
    )


def _apply_plan_result(fsm, store, index, p):
    store.upsert_plan_results(index, p["result"], p.get("eval_id", ""))
    if p.get("evals"):  # preemption follow-ups ride the same commit
        store.upsert_evals(index, p["evals"])


def _apply_merged_plan_result(fsm, store, index, p):
    store.upsert_merged_plan_results(index, p["results"])
    if p.get("evals"):  # preemption follow-ups ride the same commit
        store.upsert_evals(index, p["evals"])


def _apply_deployment_status(fsm, store, index, p):
    store.update_deployment_status(
        index, p["deployment_id"], p["status"], p.get("description", "")
    )


def _apply_deployment_upsert(fsm, store, index, p):
    store.update_deployment(index, p["deployment"])


def _apply_csi_volume_upsert(fsm, store, index, p):
    # rejections (spec change on in-use volume) surface via the generic
    # never-raise guard in FSM.apply as a returned ValueError
    store.upsert_csi_volume(index, p["volume"])


def _apply_csi_volume_deregister(fsm, store, index, p):
    store.deregister_csi_volume(
        index, p["volume_id"], force=p.get("force", False)
    )


def _apply_csi_claim(fsm, store, index, p):
    # external-claim classification is deterministic: it depends only on
    # store state at this index, identical on every replica
    external = store.alloc_by_id(p["claim_id"]) is None
    return store.csi_claim(
        index, p["volume_id"], p["claim_id"], p["node_id"],
        p["read_only"], external=external,
    )


def _apply_csi_release(fsm, store, index, p):
    return store.csi_release(index, p["volume_id"], p["claim_id"])


def _apply_acl_bootstrap(fsm, store, index, p):
    store.bootstrap_acl_token(index, p["token"])


def _apply_acl_policy_upsert(fsm, store, index, p):
    store.upsert_acl_policies(index, p["policies"])


def _apply_acl_policy_delete(fsm, store, index, p):
    store.delete_acl_policies(index, p["names"])


def _apply_acl_token_upsert(fsm, store, index, p):
    store.upsert_acl_tokens(index, p["tokens"])


def _apply_acl_token_delete(fsm, store, index, p):
    store.delete_acl_tokens(index, p["accessor_ids"])


def _apply_sched_config(fsm, store, index, p):
    store.set_scheduler_config(index, p["config"])


def _apply_namespace_upsert(fsm, store, index, p):
    store.upsert_namespace(index, p["namespace"])


def _apply_namespace_delete(fsm, store, index, p):
    store.delete_namespace(index, p["name"])


def _apply_job_scale(fsm, store, index, p):
    store.upsert_job(index, p["job"])
    if p.get("evals"):
        for ev in p["evals"]:
            ev.job_modify_index = index
        store.upsert_evals(index, p["evals"])
    job = p["job"]
    store.add_scaling_event(index, job.namespace, job.id, p["event"])


_APPLIERS = {
    MsgType.NOOP: _apply_noop,
    MsgType.JOB_UPSERT: _apply_job_upsert,
    MsgType.JOB_BATCH_GC: _apply_job_batch_gc,
    MsgType.JOB_STABLE: _apply_job_stable,
    MsgType.NODE_UPSERT: _apply_node_upsert,
    MsgType.NODE_STATUS: _apply_node_status,
    MsgType.NODE_DRAIN: _apply_node_drain,
    MsgType.NODE_ELIGIBILITY: _apply_node_eligibility,
    MsgType.EVAL_UPSERT: _apply_eval_upsert,
    MsgType.ALLOC_CLIENT_UPDATE: _apply_alloc_client_update,
    MsgType.ALLOC_DESIRED_TRANSITION: _apply_alloc_desired_transition,
    MsgType.ALLOC_HEALTH: _apply_alloc_health,
    MsgType.PLAN_RESULT: _apply_plan_result,
    MsgType.DEPLOYMENT_STATUS: _apply_deployment_status,
    MsgType.DEPLOYMENT_UPSERT: _apply_deployment_upsert,
    MsgType.CSI_VOLUME_UPSERT: _apply_csi_volume_upsert,
    MsgType.CSI_VOLUME_DEREGISTER: _apply_csi_volume_deregister,
    MsgType.CSI_CLAIM: _apply_csi_claim,
    MsgType.CSI_RELEASE: _apply_csi_release,
    MsgType.ACL_BOOTSTRAP: _apply_acl_bootstrap,
    MsgType.ACL_POLICY_UPSERT: _apply_acl_policy_upsert,
    MsgType.ACL_POLICY_DELETE: _apply_acl_policy_delete,
    MsgType.ACL_TOKEN_UPSERT: _apply_acl_token_upsert,
    MsgType.ACL_TOKEN_DELETE: _apply_acl_token_delete,
    MsgType.SCHED_CONFIG: _apply_sched_config,
    MsgType.NAMESPACE_UPSERT: _apply_namespace_upsert,
    MsgType.NAMESPACE_DELETE: _apply_namespace_delete,
    MsgType.JOB_SCALE: _apply_job_scale,
    # membership change rides the log for ordering/durability but mutates
    # raft config, not the store (RaftNode._applier intercepts it)
    MsgType.RAFT_REMOVE_PEER: _apply_noop,
    MsgType.MERGED_PLAN_RESULT: _apply_merged_plan_result,
}
