"""nomad_tpu_torch — the PyTorch/CUDA port of nomad_tpu.

The scheduling framework of ``nomad_tpu`` (a Nomad-class workload
orchestrator whose per-evaluation placement runs as dense device
programs), rebuilt on PyTorch with hand-written kernels for an NVIDIA
H100. The host control plane (structs, state store, reconciler, plan
applier) is carried over as plain Python; the device programs are
CUDA C++ (``csrc/``) and Triton kernels, each beside a plain PyTorch
version that the CPU runs.

Layer map of this slice:

- ``nomad_tpu_torch.structs``   — the shared data model.
- ``nomad_tpu_torch.state``     — MVCC snapshot state store.
- ``nomad_tpu_torch.device``    — cluster flattening + placement kernels.
- ``nomad_tpu_torch.scheduler`` — reconciler + generic scheduler + Harness.
- ``nomad_tpu_torch.broker``    — the eval broker, blocked evals, the
  event stream, the plan queue and the plan applier.
- ``nomad_tpu_torch.server``    — the server: workers, lanes, the
  optimistic overlay, the FSM, and the leader services (admission,
  heartbeats, drainer, deployments, periodic dispatch, core GC, volumes,
  ACL, the defrag controller on the migration kernel).
- ``nomad_tpu_torch.acl``       — ACL policies (HCL, ``utils/hcl.py``),
  tokens and their compiled capabilities.
- ``nomad_tpu_torch.raft`` / ``native`` — the single-server raft seam on
  the C++ WAL.
- ``nomad_tpu_torch.obs``       — tracing, explanations, the flight
  recorder and the calibration plane.
- ``nomad_tpu_torch.chaos``     — the seeded fault plane.
- ``nomad_tpu_torch.rpc``       — the restricted unpickler (snapshots).
- ``nomad_tpu_torch.backend``   — device resolution, kernel builds.
- ``nomad_tpu_torch.interop``   — build port objects from plain records.

Entry points run on the card unless the caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
SCHEDULER_VERSION = 1  # mirrors scheduler/scheduler.go:18 (SchedulerVersion)
