"""nomad_tpu_torch.analysis — repo-specific static analysis & runtime checkers.

The port of ``nomad_tpu/analysis/``. Four engines behind one CLI
(``python -m nomad_tpu_torch.analysis``) and two fast pytest entry
points (tests/test_torch_analysis.py, tests/test_torch_kernellint.py):

- ``lint``    — an AST visitor framework plus repo-specific rules
  (NTA001–NTA021) that encode the invariants the north star depends on
  but the test suite cannot see: no host sync on a kernel's launch path,
  deterministic scheduler scoring, observable exception handling, frozen
  plans after submission, class-level lock discipline, the worker batch
  path's merged-submit discipline, injectable-clock time in
  broker/server scheduling paths, and the seams every device placement
  and kernel build goes through.
- ``race``    — an env-gated (``NOMAD_TPU_RACECHECK=1``) instrumented
  ``threading.Lock``/``RLock`` wrapper that records per-thread lock
  acquisition order, builds the global lock graph, and reports cycles
  (deadlock potential) and guarded-field accesses without the owning
  lock.
- ``retrace`` — the build-budget checker over the per-kernel build
  counts the kernel guard keeps (``backend.build_counts``): a wrapper
  that starts building afresh for each new shape passes its declared
  budget (``guarded(name, build_budget=...)``) and fails the check.
- ``kernellint`` — analysis over the hand-written kernel fleet (the
  counterpart of the JAX package's ``jaxlint``): every registered
  kernel is exercised, fingerprinted from its source and checked for
  dtype discipline, determinism and build-budget hazards
  (``analyze kernels``). Imported lazily:
  ``python -m nomad_tpu_torch.analysis --source-only`` imports no kernel
  module.

Lint findings diff against the checked-in baselines
(``analysis/baseline.json`` for source rules,
``analysis/kernellint/baseline.json`` for kernel rules): pre-existing
violations are ratcheted (they stay visible and must not grow), new
ones fail the run. ``--fix-baseline`` regenerates both files
deterministically (sorted, path-relative).
"""

from . import lint, race, retrace  # noqa: F401

__all__ = ["kernellint", "lint", "race", "retrace"]


def __getattr__(name):
    # lazy: kernellint imports the kernel modules, and plain
    # `import nomad_tpu_torch.analysis` (the source lint path) must not
    if name == "kernellint":
        from . import kernellint

        return kernellint
    raise AttributeError(name)
