"""The plain versions' ``exp`` on the CPU (ROADMAP C-P1).

In about one fresh process in six, PyTorch's CPU threads compute their
first large ``torch.exp`` wrong (whole per-thread chunks off by up to
1,773 ulp; later calls right; more often under load), so a plain
version's scores could depend on its process's history. The port's
``_exp`` (``device/score.py``, every score's exponential) takes the exp
in NumPy on the CPU. Held here: in each of 6 fresh processes, one after
another (the test adds one process to the suite's load), the first
large ``_pow10`` equals the second, bit for bit, and equals NumPy's
float64 exp rounded once to float32.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROCESSES = 6

PROBE = """
import numpy as np
import torch
from nomad_tpu_torch.device.score import _LN10, _pow10
torch.manual_seed(1)
x = (torch.rand(8, 4096, 16) * 2 - 1.5) * 2.302585
a = _pow10(x)
b = _pow10(x)
want = np.exp((_LN10 * x).numpy().astype(np.float64)).astype(np.float32)
same = torch.equal(a.view(torch.int32), b.view(torch.int32))
exact = np.array_equal(a.numpy().view(np.uint32), want.view(np.uint32))
print("same" if same and exact else "differs")
"""


def _probe():
    r = subprocess.run(
        [sys.executable, "-c", PROBE], cwd=REPO, capture_output=True, text=True, timeout=120,
        env=dict(os.environ, PYTHONPATH=REPO),
    )
    assert r.returncode == 0, r.stderr[-2000:]
    return r.stdout.strip()


def test_first_exp_of_a_process_is_the_later_ones():
    seen = [_probe() for _ in range(PROCESSES)]
    assert seen == ["same"] * PROCESSES, seen
