"""SchedulerAlgorithm plugin registry — the one seam for kernel dispatch.

The reference hard-codes two algorithms behind a config enum
(SchedulerConfiguration.SchedulerAlgorithm, nomad/structs/operator.go);
this build turns that enum into a registry so heterogeneity policies
(scheduler/hetero.py) and future experiments plug in without touching
the schedulers. Mirrors the ``register_scheduler``/BUILTIN_SCHEDULERS
idiom one layer up (scheduler/scheduler.py) at the kernel layer.

Everything that dispatches a placement kernel or the dense score matrix
routes through this module, so algorithm names validate in ONE place.

In the port every factory takes the ``device`` its tensors live on:
``binpack`` and ``spread`` build the closed-form ``PlacementKernel``,
the three ``hetero-*`` algorithms ``HeteroPlacementKernel`` (the
hetero-greedy kernel), ``cp-pack`` and ``cp-gang`` the CP auction
kernels, and ``score_group`` and ``score_groups`` run the port's
``score_matrix``.
"""

from __future__ import annotations

import numpy as np


class UnknownAlgorithmError(ValueError):
    """Raised for algorithm names nothing registered (API surfaces 400)."""


ALGORITHMS: dict[str, "SchedulerAlgorithm"] = {}


class SchedulerAlgorithm:
    """One registered placement algorithm: a name plus a kernel factory.

    ``make_kernel`` must return an object with the PlacementKernel
    ``place(cluster, asks, **kwargs) -> list[PlacementResult]`` contract
    (device/score.py); the generic scheduler treats all algorithms
    uniformly through it.
    """

    name: str = ""
    description: str = ""
    # hetero algorithms only differentiate on fleets with device classes
    requires_device_classes: bool = False

    def make_kernel(self, force_scan: bool = False, mesh=None, device="cuda"):
        raise NotImplementedError


def register_algorithm(cls):
    """Class decorator: instantiate and index by ``name`` (last wins,
    like register_scheduler — tests override with instrumented doubles)."""
    inst = cls()
    if not inst.name:
        raise ValueError("SchedulerAlgorithm needs a non-empty name")
    ALGORITHMS[inst.name] = inst
    return cls


def available() -> list[str]:
    return sorted(ALGORITHMS)


def is_registered(name: str) -> bool:
    return name in ALGORITHMS


def get_algorithm(name: str) -> SchedulerAlgorithm:
    algo = ALGORITHMS.get(name)
    if algo is None:
        raise UnknownAlgorithmError(
            f"unknown scheduler algorithm {name!r}; "
            f"available: {', '.join(available())}"
        )
    return algo


def make_kernel(name: str, force_scan: bool = False, mesh=None, device="cuda"):
    """The factory seam: scheduler_algorithm config string → kernel on
    ``device``."""
    return get_algorithm(name).make_kernel(force_scan, mesh=mesh, device=device)


# -- built-ins ---------------------------------------------------------------


@register_algorithm
class BinpackAlgorithm(SchedulerAlgorithm):
    name = "binpack"
    description = "maximize per-node utilization (reference default)"

    def make_kernel(self, force_scan: bool = False, mesh=None, device="cuda"):
        from ..device.score import PlacementKernel

        return PlacementKernel("binpack", force_scan, mesh=mesh, device=device)


@register_algorithm
class SpreadAlgorithm(SchedulerAlgorithm):
    name = "spread"
    description = "prefer empty nodes (inverse binpack fit)"

    def make_kernel(self, force_scan: bool = False, mesh=None, device="cuda"):
        from ..device.score import PlacementKernel

        return PlacementKernel("spread", force_scan, mesh=mesh, device=device)


class _HeteroAlgorithm(SchedulerAlgorithm):
    requires_device_classes = True
    policy = ""

    def make_kernel(self, force_scan: bool = False, mesh=None, device="cuda"):
        from .hetero import HeteroPlacementKernel

        return HeteroPlacementKernel(
            self.policy, force_scan, mesh=mesh, device=device
        )


@register_algorithm
class HeteroMaxMinAlgorithm(_HeteroAlgorithm):
    name = "hetero-maxmin"
    policy = "maxmin"
    description = "max-min fair normalized throughput across jobs (Gavel)"


@register_algorithm
class HeteroMakespanAlgorithm(_HeteroAlgorithm):
    name = "hetero-makespan"
    policy = "makespan"
    description = "minimize modeled batch makespan (LPT on class rates)"


@register_algorithm
class HeteroCostAlgorithm(_HeteroAlgorithm):
    name = "hetero-cost"
    policy = "cost"
    description = "maximize throughput per device-class cost"


@register_algorithm
class CpPackAlgorithm(SchedulerAlgorithm):
    name = "cp-pack"
    description = (
        "whole-batch joint placement: assignment relaxation over the "
        "score matrix, solved on device by iterated proportional rounding"
    )

    def make_kernel(self, force_scan: bool = False, mesh=None, device="cuda"):
        from .cp import CpPlacementKernel

        return CpPlacementKernel(force_scan, mesh=mesh, device=device)


@register_algorithm
class CpGangAlgorithm(SchedulerAlgorithm):
    name = "cp-gang"
    description = (
        "cp-pack plus all-or-nothing gangs: topology-priced co/anti-"
        "location with atomic release of incomplete gangs"
    )

    def make_kernel(self, force_scan: bool = False, mesh=None, device="cuda"):
        from .cp import CpGangPlacementKernel

        return CpGangPlacementKernel(force_scan, mesh=mesh, device=device)


# -- registry-routed score matrix -------------------------------------------


def _normalized_throughputs(ga):
    """The ask's heterogeneity axis normalized by its best eligible class
    (f32[N]), or None where it carries none or no eligible class has a
    positive rate."""
    if not (ga.has_throughputs and ga.throughputs is not None):
        return None
    tp = ga.throughputs.astype(np.float32)
    best = float(np.max(np.where(ga.eligible, tp, 0.0)))
    return tp / np.float32(best) if best > 0.0 else None


def score_groups(ct, asks: list, desired_totals, algorithm_spread: bool = False,
                 device="cuda", mesh=None):
    """Dense score rows of several flattened group asks against one
    cluster snapshot: row i equals ``score_group(ct, asks[i],
    desired_totals[i], algorithm_spread)``. One ``score_matrix`` launch
    over every ask, or two where only some carry a throughput axis (with
    and without it); each input is copied to the device once a launch.
    Under an active ``mesh`` the inputs are laid out over it and the
    matrix runs a launch per node slice (``score_matrix_sharded``), read
    back gathered on the lead.

    Returns (finals f32[G, N], fits bool[G, N]) as numpy."""
    import torch

    from ..backend import resolve_device, shard_put
    from ..device.score import _BATCH_SPECS, capacity_on, score_matrix, used_device

    dev = resolve_device(device)
    g, pn = len(asks), ct.capacity.shape[0]
    finals = np.empty((g, pn), dtype=np.float32)
    fits = np.empty((g, pn), dtype=bool)
    tps = [_normalized_throughputs(ga) for ga in asks]
    cfg = mesh if mesh is not None and mesh.active else None

    def t(x, dtype, name=None):
        x = np.ascontiguousarray(x, dtype=dtype)
        if cfg is not None and name is not None:
            return shard_put(x, _BATCH_SPECS[name], cfg)
        return torch.from_numpy(x).to(dev)

    if cfg is not None:
        capacity = capacity_on(ct, dev, cfg)
    else:
        capacity = t(ct.capacity, np.float32)
    used = used_device(ct, np.asarray(ct.used), dev, cfg)
    for with_tp in (False, True):
        rows = [i for i, tp in enumerate(tps) if (tp is not None) == with_tp]
        if not rows:
            continue
        sub = [asks[i] for i in rows]
        f, ok = score_matrix(
            capacity,
            used,
            t(np.stack([ga.ask for ga in sub]), np.float32, "asks"),
            t(np.stack([ga.eligible for ga in sub]), bool, "eligible"),
            t(np.stack([ga.job_counts for ga in sub]), np.int32, "job_counts"),
            t([float(max(desired_totals[i], 1)) for i in rows], np.float32, "desired_totals"),
            t(np.stack([ga.penalty_nodes for ga in sub]), bool, "penalty_nodes"),
            t(np.stack([ga.affinity_scores for ga in sub]), np.float32, "affinity_scores"),
            t([ga.has_affinities for ga in sub], bool, "has_affinities"),
            t([ga.distinct_hosts for ga in sub], bool, "distinct_hosts"),
            bool(algorithm_spread),
            t(np.stack([tps[i] for i in rows]), np.float32, "throughputs") if with_tp else None,
        )
        finals[rows] = f.cpu().numpy()
        fits[rows] = ok.cpu().numpy()
    return finals, fits


def score_group(
    ct,
    ga,
    desired_total: float,
    algorithm_spread: bool = False,
    explain: bool = False,
    device="cuda",
    mesh=None,
):
    """Dense score row for one flattened group ask — the registry-routed
    wrapper over the port's ``score_matrix`` for matrix consumers
    (system scheduler, annotation). Feeds the heterogeneity axis when the
    ask carries one: coefficients normalize by the job's best eligible
    class so the score term lands in [0, 1] like every other component.

    Returns (finals f32[N], fits bool[N]) as numpy; with ``explain`` the
    return grows a third element, an ``obs.explain.PlacementExplanation``
    carrying top-k candidates and the feasibility-rejection histogram.
    Under an active ``mesh`` the row is scored a node slice a launch."""
    finals, fits = score_groups(
        ct, [ga], [desired_total], algorithm_spread, device, mesh=mesh
    )
    finals, fits = finals[0], fits[0]
    if not explain:
        return finals, fits
    from ..obs.explain import explain_group

    ex = explain_group(
        ct,
        ga,
        np.asarray(ct.used),
        algorithm="spread" if algorithm_spread else "binpack",
        algorithm_spread=algorithm_spread,
        throughputs=_normalized_throughputs(ga),
        desired_total=float(max(desired_total, 1)),
    )
    return finals, fits, ex
