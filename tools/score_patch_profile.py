"""The incremental seam's ``used`` upload on one NVIDIA GPU, whole against
served by the score-state cache.

    python3 tools/score_patch_profile.py

At the schedule path's shape (16,384 rows × 4 f32, 256 KiB) and 0, 16,
128, 1,000, 4,096 and 16,384 dirty rows, times the median of ``REPS``
calls, each on the host clock from the call to its return after a
device synchronize:

- ``whole``: the seam off, ``torch.from_numpy(used).to(dev)``;
- ``view``: ``DeviceStateCache.score_view`` with a commit after it (the
  diff, then a reuse or a whole upload counted as a patch), alternating
  two arrays that differ in the dirty rows;
- ``diff``: the bytewise diff alone (``_dirty_rows``), the host work the
  seam adds to every pass.

Every generation the cache served is checked bitwise against its
``used``. Prints the card's name and power limit first, one line a case
and a JSON summary last. No jax.
"""

import json
import os
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import chip_smoke as C  # noqa: E402
from nomad_tpu_torch import backend  # noqa: E402
from nomad_tpu_torch.device.cache import DeviceStateCache, _dirty_rows  # noqa: E402

ROWS, DIMS = 16_384, 4
DIRTY = (0, 16, 128, 1_000, 4_096, 16_384)
REPS = 50


def host_ms(fn, dev):
    """ms on the host clock of ``fn()`` then a device synchronize."""
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize(dev)
    return (time.perf_counter() - t0) * 1e3, out


def case(dev, k, rng):
    base = rng.integers(0, 4_000, (ROWS, DIMS)).astype(np.float32)
    moved = base.copy()
    rows = np.sort(rng.choice(ROWS, size=k, replace=False))
    moved[rows, 0] += 1.0
    variants = (moved, base)
    ct = SimpleNamespace(layout_gen=1)
    cache = DeviceStateCache(dev)
    cache.score_view(ct, base)
    cache.score_commit()
    times = {key: [] for key in ("whole", "view", "diff")}
    for i in range(REPS + 1):
        used = variants[i % 2]
        ms_whole, _ = host_ms(lambda: torch.from_numpy(used).to(dev), dev)
        ms_view, served = host_ms(lambda: cache.score_view(ct, used), dev)
        cache.score_commit()
        assert np.array_equal(served.cpu().numpy().view(np.uint32), used.view(np.uint32))
        other = variants[(i + 1) % 2]
        ms_diff, dirty = host_ms(lambda: _dirty_rows(other, used), dev)
        assert dirty.size == k
        if i == 0:
            continue  # first calls: allocations and module loads
        for key, value in (("whole", ms_whole), ("view", ms_view), ("diff", ms_diff)):
            times[key].append(value)
    assert cache.verify_score_view() == []
    c = cache.device_counters()
    out = {key: float(np.median(v)) for key, v in times.items()}
    out["patches"] = c["score_patch_uploads"]
    out["reused_rows"] = c["score_rows_reused"]
    return out


def main() -> int:
    dev = backend.resolve_device("cuda")
    print(C.card_line(), flush=True)
    os.environ["NOMAD_TPU_INCREMENTAL"] = "on"
    backend.reset_incremental()
    rng = np.random.default_rng(0)
    summary = {}
    for k in DIRTY:
        r = case(dev, k, rng)
        summary[str(k)] = r
        print(
            f"dirty {k:>6}: whole {r['whole']:.4f} ms, view {r['view']:.4f} ms, "
            f"diff {r['diff']:.4f} ms ({REPS} calls, medians)",
            flush=True,
        )
    print(json.dumps({"rows": ROWS, "dims": DIMS, "reps": REPS, "by_dirty_rows": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
