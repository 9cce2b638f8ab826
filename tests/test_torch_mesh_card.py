"""The cross-shard top-k merge kernel (``closed_form_topk_merge``,
``csrc/closed_form.cu``) and the sharded closed form on the card.

Imports no JAX: it runs where the card is. Every test is marked ``cuda``
and skips without one. Candidates are made as a shard makes them (a
stable per-shard top-k' of a tie-heavy plane, or the closed form itself
on a shard's node slice) and the kernel's fused output is held bit for
bit (uint32 views) to ``closed_form_topk_merge_plain`` on the same card
and to the stable global sort: at ties, at k' < k (shards forward fewer
than k), at seg x J < k (fewer candidates than k, the tail row -1 /
-inf), at S 1, 2, 4 and 8.
"""

import numpy as np
import pytest
import torch

from nomad_tpu_torch import backend
from nomad_tpu_torch.device import score as S


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs CUDA: the merge kernel runs only on the card")
    return torch.device("cuda")


def _shard_candidates(flat, s, k, dev):
    """A group's per-shard stable top-k' of each row of ``flat`` [G, N]
    (J = 1: a column is a node), as the shards hand them over."""
    g, n = flat.shape
    seg = n // s
    kl = min(k, seg)
    rows, scores = [], []
    for j in range(s):
        v, i = torch.sort(flat[:, j * seg:(j + 1) * seg], dim=1, descending=True, stable=True)
        rows.append(i[:, :kl].to(torch.int32).contiguous().to(dev))
        scores.append(v[:, :kl].contiguous().to(dev))
    return rows, scores, seg


CASES = {
    # name: (groups, nodes, k, values)
    "ties": (8, 1024, 32, (-np.inf, 0.0, 1.0, 2.0, 3.0)),
    "k_local_below_k": (4, 256, 128, (0.0, 0.5, 1.0)),
    "fewer_than_k": (3, 16, 64, (-np.inf, 1.0, 2.0)),
    "wide": (100, 4096, 128, None),
}


@pytest.mark.cuda
@pytest.mark.parametrize("shards", [1, 2, 4, 8])
@pytest.mark.parametrize("case", sorted(CASES))
def test_cuda_merge_matches_plain(case, shards):
    dev = _card()
    g, n, k, values = CASES[case]
    rng = np.random.default_rng(shards * 31 + len(case))
    if values is None:
        flat = rng.standard_normal((g, n)).astype(np.float32)
        flat[:, ::7] = -np.inf
    else:
        flat = rng.choice(np.array(values, dtype=np.float32), size=(g, n))
    flat = torch.from_numpy(flat)
    rows, scores, seg = _shard_candidates(flat, shards, k, dev)
    before = S.closed_form_topk_merge.launches
    got = S.closed_form_topk_merge(rows, scores, seg, k)
    assert S.closed_form_topk_merge.launches == before + 1
    want = S.closed_form_topk_merge_plain(rows, scores, seg, k)
    assert torch.equal(got, want), case
    # the stable global sort of the whole plane, -1 / -inf past its end
    v, i = torch.sort(flat, dim=1, descending=True, stable=True)
    m = min(k, n)
    got = got.cpu()
    assert torch.equal(got[:, :m], i[:, :m].to(torch.int32))
    assert torch.equal(got[:, k:k + m], v[:, :m].view(torch.int32))
    assert (got[:, m:k] == -1).all()
    assert torch.isneginf(got[:, k + m:].view(torch.float32)).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dp,mp", [(1, 4), (2, 2), (2, 4), (1, 8)])
def test_cuda_sharded_closed_form_matches_one_device(dp, mp):
    """The closed form with inputs laid out over a mesh whose cells all
    name the one card: a shard launch per cell and a merge per groups
    row, identical to the one-device launch and to the plain version."""
    dev = _card()
    rng = np.random.default_rng(dp * 10 + mp)
    g, n, j, k = 8, 4096, 16, 64
    cap = np.tile(np.array([4000, 8192, 102400, 1000], np.float32), (n, 1))
    cap[::3, 0] = 8000
    used = (cap * rng.uniform(0, 0.5, (n, 1))).astype(np.float32)
    batch = dict(
        asks=np.tile(np.array([[500, 256, 300, 0]], np.float32), (g, 1)),
        eligible=rng.random((g, n)) < 0.9,
        job_counts=rng.integers(0, 2, (g, n)).astype(np.int32),
        desired_totals=np.full(g, 40.0, np.float32),
        penalty_nodes=rng.random((g, n)) < 0.05,
        affinity_scores=np.zeros((g, n), np.float32),
        has_affinities=np.zeros(g, bool),
        distinct_hosts=np.zeros(g, bool),
        slot_caps=np.full((g, n), np.inf, np.float32),
    )
    one_in = {k_: torch.from_numpy(v).to(dev) for k_, v in batch.items()}
    cap_t, used_t = torch.from_numpy(cap).to(dev), torch.from_numpy(used).to(dev)
    one = S.place_closed_form(cap_t, used_t, **one_in, algorithm_spread=False, max_j=j, k=k)
    plain = S.place_closed_form_plain(cap_t, used_t, *one_in.values(), False, j, k)
    cfg = backend.make_mesh(dp, mp, dev)
    sharded = {k_: backend.shard_put(v, S._BATCH_SPECS[k_], cfg) for k_, v in batch.items()}
    backend.reset_mesh_layouts()
    got = S.place_closed_form(
        backend.shard_put(cap, ("nodes",), cfg), backend.shard_put(used, ("nodes",), cfg),
        **sharded, algorithm_spread=False, max_j=j, k=k,
    )
    for a, b, c in zip(got, one, plain):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert torch.equal(a.view(torch.int32), c.view(torch.int32))
    layouts = backend.mesh_layouts()
    assert layouts["place_closed_form:shard"] == dp * mp
    assert layouts["closed_form_topk_merge:merge"] == dp
