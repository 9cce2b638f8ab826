"""Property sets — per-attribute-value usage accounting.

Reference: scheduler/propertyset.go:14-52 (propertySet), :230-275
(UsedCount/GetCombinedUseMap). A property set tracks how many allocations
of a job (or one task group) sit on nodes carrying each value of an
attribute. Three layers combine:

- **existing**: non-terminal allocations already in state,
- **proposed**: allocations in the in-flight plan (NodeAllocation),
- **cleared**:  allocations the plan stops (NodeUpdate), discounted from
  the combined count — minus one per value that a proposed alloc re-uses
  (propertyset.go:199-208).

combined[v] = max(existing[v] + proposed[v] - cleared[v], 0)

Two consumers (the same split as the reference):
- spread scoring (scheduler/spread.go) reads the combined map as the
  initial per-value counts the placement kernel carries through its scan;
- distinct_property feasibility (feasible.go:604-707) turns
  ``allowedCount`` minus the combined count into a per-value cap.

The TPU twist: instead of a hash map consulted per node per placement,
the counts are flattened once into dense per-value-id vectors aligned
with a ClusterTensors attribute column (flatten.py ``attr_column``) and
the kernel updates them on device as it places.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class PropertySet:
    """Host-side combined-use accounting for one (job[, task group],
    attribute). ``allowed_count`` is 0 for spread use (no cap)."""

    namespace: str
    job_id: str
    attribute: str
    task_group: str = ""  # empty = job-level (all task groups count)
    allowed_count: int = 0
    existing: dict[str, int] = field(default_factory=dict)
    proposed: dict[str, int] = field(default_factory=dict)
    cleared: dict[str, int] = field(default_factory=dict)

    # -- population (propertyset.go:129-208) ------------------------------
    def _node_value(self, snap, node_id: str, node_cache: dict):
        node = node_cache.get(node_id)
        if node is None:
            node = snap.node_by_id(node_id)
            node_cache[node_id] = node
        if node is None:
            return None
        v = node.lookup_attribute(self.attribute)
        return None if v is None else str(v)

    def _wanted(self, alloc, *, filter_terminal: bool) -> bool:
        if filter_terminal and alloc.terminal_status():
            return False
        if self.task_group and alloc.task_group != self.task_group:
            return False
        return True

    def populate(self, snap, plan=None) -> "PropertySet":
        """Build all three layers from a state snapshot and (optionally)
        the in-flight plan."""
        node_cache: dict = {}
        self.existing = {}
        for a in snap.allocs_by_job(self.namespace, self.job_id):
            if not self._wanted(a, filter_terminal=True):
                continue
            v = self._node_value(snap, a.node_id, node_cache)
            if v is not None:
                self.existing[v] = self.existing.get(v, 0) + 1

        self.proposed = {}
        self.cleared = {}
        if plan is not None:
            for stops in plan.node_update.values():
                for a in stops:
                    if a.job_id != self.job_id or not self._wanted(
                        a, filter_terminal=False
                    ):
                        continue
                    v = self._node_value(snap, a.node_id, node_cache)
                    if v is not None:
                        self.cleared[v] = self.cleared.get(v, 0) + 1
            for allocs in plan.node_allocation.values():
                for a in allocs:
                    if a.job_id != self.job_id or not self._wanted(
                        a, filter_terminal=True
                    ):
                        continue
                    v = self._node_value(snap, a.node_id, node_cache)
                    if v is not None:
                        self.proposed[v] = self.proposed.get(v, 0) + 1
            # a cleared value re-used by a proposed alloc stops discounting
            # (propertyset.go:199-208)
            for v in self.proposed:
                cur = self.cleared.get(v)
                if cur is None:
                    continue
                if cur <= 1:
                    del self.cleared[v]
                else:
                    self.cleared[v] = cur - 1
        return self

    # -- reads (propertyset.go:230-275) -----------------------------------
    def combined_use(self) -> dict[str, int]:
        out: dict[str, int] = {}
        for layer in (self.existing, self.proposed):
            for v, n in layer.items():
                out[v] = out.get(v, 0) + n
        for v, n in self.cleared.items():
            if v in out:
                out[v] = max(out[v] - n, 0)
        return out

    def used_count(self, value: str) -> int:
        return self.combined_use().get(value, 0)

    def satisfies_distinct_property(self, value: str | None) -> tuple[bool, str]:
        """feasible.go:604 SatisfiesDistinctProperties: a node is feasible
        iff its value's combined use is below allowed_count; a node
        missing the property is infeasible."""
        if value is None:
            return False, f'missing property "{self.attribute}"'
        used = self.used_count(value)
        if used < self.allowed_count:
            return True, ""
        return (
            False,
            f"distinct_property: {self.attribute}={value} used by {used} allocs",
        )
