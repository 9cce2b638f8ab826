"""The chaos runner's stepped defragmentation (ROADMAP C-P4): with the
defrag cycles stepped by the runner between drained ops, and admission
on op time, what a seed does depends on the seed alone.

The same seed, run twice in one process on the CPU, gives the same
kernel refusals (which jobs' evals a refused or timed-out kernel call
nacked, and how each ended), the same defrag moves (job, alloc name,
source and destination node) and the same fired faults. Seed 5 at 40
steps is the default mix whose kernel faults land on the worker's
placements; seed 11 at 60 steps is the one whose cycles plan moves.

Tolerance: exact.
"""

import pytest

from nomad_tpu_torch.chaos import run_chaos


def _run(seed, steps):
    run = run_chaos(seed=seed, steps=steps, device="cpu", quiesce_timeout=60.0)
    assert run.ok, run.render()
    return run


@pytest.mark.parametrize(
    "seed,steps,moves,refused",
    [(5, 40, False, True), (11, 60, True, False)],
    ids=["seed5", "seed11"],
)
def test_same_seed_same_refusals_and_moves(seed, steps, moves, refused):
    a, b = _run(seed, steps), _run(seed, steps)
    assert a.report.info["kernel_refusals"] == b.report.info["kernel_refusals"]
    assert a.report.info["defrag_moves"] == b.report.info["defrag_moves"]
    assert sorted(a.triggered) == sorted(b.triggered)
    assert a.workload == b.workload
    if moves:
        assert a.report.info["defrag_moves"]
    if refused:
        assert a.report.info["kernel_refusals"]["evals"] >= 1
