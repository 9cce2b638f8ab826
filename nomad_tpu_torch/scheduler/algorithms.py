"""SchedulerAlgorithm plugin registry — the one seam for kernel dispatch.

The reference hard-codes two algorithms behind a config enum
(SchedulerConfiguration.SchedulerAlgorithm, nomad/structs/operator.go);
this build turns that enum into a registry so heterogeneity policies
(scheduler/hetero.py) and future experiments plug in without touching
the schedulers. Mirrors the ``register_scheduler``/BUILTIN_SCHEDULERS
idiom one layer up (scheduler/scheduler.py) at the kernel layer.

Everything that dispatches a placement kernel or the dense score matrix
routes through this module, so algorithm names validate in ONE place.

In the port, ``binpack`` and ``spread`` build the closed-form
``PlacementKernel`` and ``score_group`` runs the port's ``score_matrix``;
each takes the ``device`` its tensors live on. The hetero and CP
algorithms stay registered (their names still validate) but raise
``NotImplementedError`` until their kernels are ported (ROADMAP A10,
A11).
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


class _UnportedAlgorithm(SchedulerAlgorithm):
    roadmap = ""

    def make_kernel(self, force_scan: bool = False, mesh=None, device="cuda"):
        raise NotImplementedError(
            f"nomad_tpu_torch: the {self.name} algorithm is not ported yet "
            f"(ROADMAP {self.roadmap})"
        )


class _HeteroAlgorithm(_UnportedAlgorithm):
    requires_device_classes = True
    roadmap = "A10"


@register_algorithm
class HeteroMaxMinAlgorithm(_HeteroAlgorithm):
    name = "hetero-maxmin"
    description = "max-min fair normalized throughput across jobs (Gavel)"


@register_algorithm
class HeteroMakespanAlgorithm(_HeteroAlgorithm):
    name = "hetero-makespan"
    description = "minimize modeled batch makespan (LPT on class rates)"


@register_algorithm
class HeteroCostAlgorithm(_HeteroAlgorithm):
    name = "hetero-cost"
    description = "maximize throughput per device-class cost"


@register_algorithm
class CpPackAlgorithm(_UnportedAlgorithm):
    name = "cp-pack"
    roadmap = "A11"
    description = (
        "whole-batch joint placement: assignment relaxation over the "
        "score matrix, solved on device by iterated proportional rounding"
    )


@register_algorithm
class CpGangAlgorithm(_UnportedAlgorithm):
    name = "cp-gang"
    roadmap = "A11"
    description = (
        "cp-pack plus all-or-nothing gangs: topology-priced co/anti-"
        "location with atomic release of incomplete gangs"
    )


# -- registry-routed score matrix -------------------------------------------


def score_group(
    ct,
    ga,
    desired_total: float,
    algorithm_spread: bool = False,
    explain: bool = False,
    device="cuda",
):
    """Dense score row for one flattened group ask — the registry-routed
    wrapper over the port's ``score_matrix`` for matrix consumers
    (system scheduler, annotation). Feeds the heterogeneity axis when the
    ask carries one: coefficients normalize by the job's best eligible
    class so the score term lands in [0, 1] like every other component.

    Returns (finals f32[N], fits bool[N]) as numpy; with ``explain`` the
    return grows a third element, an ``obs.explain.PlacementExplanation``
    carrying top-k candidates and the feasibility-rejection histogram."""
    import torch

    from ..backend import resolve_device
    from ..device.score import score_matrix

    dev = resolve_device(device)
    throughputs = None
    if ga.has_throughputs and ga.throughputs is not None:
        tp = ga.throughputs.astype(np.float32)
        best = float(np.max(np.where(ga.eligible, tp, 0.0)))
        if best > 0.0:
            throughputs = (tp / np.float32(best))[None, :]

    def t(x, dtype):
        return torch.from_numpy(np.ascontiguousarray(x, dtype=dtype)).to(dev)

    finals, fits = score_matrix(
        t(ct.capacity, np.float32),
        t(ct.used, np.float32),
        t(ga.ask[None, :], np.float32),
        t(ga.eligible[None, :], bool),
        t(ga.job_counts[None, :], np.int32),
        t([float(max(desired_total, 1))], np.float32),
        t(ga.penalty_nodes[None, :], bool),
        t(ga.affinity_scores[None, :], np.float32),
        t([ga.has_affinities], bool),
        t([ga.distinct_hosts], bool),
        bool(algorithm_spread),
        None if throughputs is None else t(throughputs, np.float32),
    )
    finals = finals.cpu().numpy()[0]
    fits = fits.cpu().numpy()[0]
    if not explain:
        return finals, fits
    from ..obs.explain import explain_group

    ex = explain_group(
        ct,
        ga,
        np.asarray(ct.used),
        algorithm="spread" if algorithm_spread else "binpack",
        algorithm_spread=algorithm_spread,
        throughputs=throughputs[0] if throughputs is not None else None,
        desired_total=float(max(desired_total, 1)),
    )
    return finals, fits, ex
