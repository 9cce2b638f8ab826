"""The kernel fleet: the guard's table (``backend.kernel_registry``).

The reference's fleet is its ``traced_jit`` registry, whose recorded
abstract specs ``jaxlint/retracer.py`` re-traces into jaxprs. The port's
kernels are hand-written and have no jaxpr, so nothing is re-traced: the
fleet is the registry of kernel wrappers, keyed by the reference's
kernel names — the 11 ``@guarded`` wrappers, ``closed_form_topk_merge``,
which launches inside the closed form's guard, the three kernels of the
coupled scans under a mesh (``coupled_shard_step``,
``coupled_step_merge``, ``coupled_shard_apply``), which launch inside
the calling scan's, and the three of the hetero pass and the three of
the CP and gang auctions under a mesh (``hetero_shard_step``,
``hetero_step_merge``, ``hetero_shard_apply``; ``cp_shard_claim``,
``cp_round_merge``, ``cp_shard_settle``), which launch inside their
pass's.
"""

from __future__ import annotations

from ... import backend

#: the fleet, by the reference's kernel names
FLEET = (
    "place_closed_form_kernel",
    "score_matrix_kernel",
    "place_value_scan_kernel",
    "place_spread_chunked_kernel",
    "place_spread_opv_kernel",
    "find_preemption_kernel",
    "choose_preemption_node_kernel",
    "hetero_place_kernel",
    "cp_place_kernel",
    "cp_gang_place_kernel",
    "migrate_plan_kernel",
    "closed_form_topk_merge",
    "coupled_shard_step",
    "coupled_step_merge",
    "coupled_shard_apply",
    "hetero_shard_step",
    "hetero_step_merge",
    "hetero_shard_apply",
    "cp_shard_claim",
    "cp_round_merge",
    "cp_shard_settle",
)

#: kernels whose wrappers are defined under these module prefixes are
#: "the production fleet" — test-fixture kernels registered by a pytest
#: process are excluded from whole-fleet checks
PRODUCTION_PREFIXES = ("nomad_tpu_torch.",)


def import_fleet() -> dict:
    """Import every module that defines a kernel wrapper (decoration
    registers it), then return the registry."""
    from ...device import cp, migrate, preempt, score  # noqa: F401
    from ...scheduler import hetero  # noqa: F401

    return backend.kernel_registry()


def production_kernels(registry=None) -> dict:
    reg = registry if registry is not None else backend.kernel_registry()
    return {
        name: entry
        for name, entry in sorted(reg.items())
        if entry.module.startswith(PRODUCTION_PREFIXES)
    }
