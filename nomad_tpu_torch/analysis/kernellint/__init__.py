"""kernellint — analysis over the hand-written kernel fleet.

The port of ``nomad_tpu/analysis/jaxlint/``. The NTA rules
(``analysis.rules``) read Python source; they cannot see what the
kernels are given and give back. This package closes that gap over the
port's kernel registry (``backend.kernel_registry``: every ``@guarded``
wrapper and the mesh's merge, keyed by the reference's kernel names):
the fleet exercise (``exercise``) calls every kernel on a tiny seeded
workload on the card (or ``device="cpu"``) and records each call, and
the JXL rules read the calls, the builds and the sources. What maps to
what:

- ``jaxlint/retracer.py`` (jaxpr re-tracing) — no counterpart: a
  hand-written kernel has no jaxpr; the fleet is the registry itself
  (``registry``).
- ``jaxlint/exercise.py`` → ``exercise``: the same 16-node fleet, plus a
  1x2-mesh closed-form pass that runs the merge.
- ``jaxlint/fingerprint.py`` (JXL006) → ``fingerprint``: a hash of the
  source a kernel is built from (the CUDA library hash and symbol; the
  Triton body, its constants and each specialization launched).
- ``jaxlint/rules.py`` → ``rules``: JXL003 dtype discipline, JXL004
  determinism (two runs bit for bit; no float atomics in the sources),
  JXL005 build hazards (no budget, never called, a build in the second
  pass). JXL001 (host callbacks) and JXL002 (baked host constants) have
  no counterpart: a hand-written kernel has no callback primitive and
  its constants are in the hashed source.
- ``jaxlint/diff.py`` → ``diff``: explain, incremental and mesh on/off,
  proven over the kernels and fingerprints each side launches.
- ``jaxlint/engine.py`` → ``engine``: ``analyze_kernels`` and
  ``run_kernellint``, ratcheted against ``kernellint/baseline.json``.

Run via ``python -m nomad_tpu_torch.analysis`` (combined) or
``nomad-tpu analyze kernels``.
"""

from .engine import analyze_kernels, default_baseline_path, run_kernellint
from .fingerprint import fingerprint_table
from .registry import FLEET, import_fleet, production_kernels

__all__ = [
    "FLEET",
    "analyze_kernels",
    "default_baseline_path",
    "fingerprint_table",
    "import_fleet",
    "production_kernels",
    "run_kernellint",
]
