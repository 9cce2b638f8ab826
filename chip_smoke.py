"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the port's kernels from the sources in this checkout, holds each
against its plain PyTorch version on the card at the shapes the main
paths give it, then schedules service, spread, distinct_property,
preempting, system, heterogeneity-aware, CP and gang jobs end to end through the port's
``Harness(device="cuda")``, the port's server and its dev agent (the
CLI, the HTTP API and the SDK, the client's driver, device and CSI
plugins) and checks what lands in the state store,
and repacks a fragmented fleet through the port's migration plane. It
imports nothing of JAX and nothing of the JAX package.

Phases (none is wrapped in a ``try``; any failure exits non-zero):

1. the card's name and power limit; build the CUDA libraries (one nvcc
   per ``csrc/*.cu``, started together) and JIT the Triton kernel;
2. ``place_closed_form`` (CUDA) against ``place_closed_form_plain`` at
   the headline shape — 10,000 nodes (padded to 16,384), 100 service
   groups x 1,000 allocs, binpack (the JAX package's ``bench.py kernel``
   shape) — and on a smaller case with every score component live;
3. ``score_matrix`` (Triton) against ``component_scores`` at
   [128, 16,384], without and with the throughput term, and at G 1, 3
   and 100; then one batched ``build_cp_batch`` pass (``run_cp_ab``'s
   fleet and asks: 10,000 nodes, 100 jobs) against the per-ask
   ``score_group`` loop it replaced: the same rows bit for bit from one
   score-matrix launch (two with mixed throughputs);
4. a small end-to-end run on the card against the same run on the CPU,
   service jobs and one each of even-spread, target-spread and
   distinct_property jobs;
5. the paths of the slice, each with the launch counters zeroed just
   before it and read just after it:
   - "schedule": 10,000 mock nodes, 10 service jobs x 1,000 allocs at
     500 MHz / 256 MiB, each eval processed by the port's Harness on
     the card (one closed-form launch per placement pass, no score
     matrix);
   - "score_group": each job's group annotated against the committed
     state through the registry's ``score_group`` seam (one score-matrix
     launch per job, no closed form);
   - "incremental": the schedule recipe's 10 evals (the same nodes and
     jobs, built once) on four fresh harnesses, ``NOMAD_TPU_INCREMENTAL``
     off, on, on and off, a ``score_commit`` and ``verify_score_view()
     == []`` after each eval on: the same node rows and uint32 scores a
     pass and the same allocs, and the score-state counters that
     ``tests/test_torch_incremental.py`` predicts; every ``used`` upload
     timed (host clock, and CUDA events around it), then
     ``UPLOAD_REPEATS`` uploads a kind on the committed state;
   - "incremental_spread", "incremental_hetero", "incremental_cp": the
     same check, seam off then on, for the kernels that read ``used``
     through the seam beside the closed form: 8 of the spread path's
     jobs (one-per-value, chunked and value-scan kernels), the hetero
     path's 12 jobs under hetero-maxmin and the cp path's 12 under
     cp-pack (score matrix and CP auction), each on 10,000 nodes; their
     recorded calls replayed against the plain versions;
   - "batch": those 10 evals prepared against one ClusterTensors and
     merged into ONE closed-form call (``Harness.process_merged``):
     every alloc placed, no rejected or over-committed node;
   - "plan": ``plan_job`` (the dry-run ``job plan``) of a new job of
     1,000 allocs on the batch path's store, nothing committed;
   - "server": ``bench_torch.py``'s end-to-end bench on the card
     (``SERVER_BENCH``: bench.py's end_to_end shape, 10,000 nodes over
     25 racks, 100 jobs x 250 allocs with an even rack spread and an ssd
     affinity, mixed service/batch) through the port's server: the
     broker, one batching worker whose pipelined commit thread overlaps
     the next pass, the plan queue and the merged-plan applier, after
     the bench's warmup and drain; drained, no unaccounted alloc, no
     over-committed node, no failed eval, no swallowed exception and no
     batched pass retried solo; its allocs/s, evals/s, eval p50 / p99 and
     ``phase_breakdown_ms`` logged; every closed-form and coupled call
     of both threads recorded and replayed against the plain version;
   - "leader": a server with every leader service running (admission,
     heartbeats, drainer, deployment watcher, periodic dispatch, core GC,
     volume watcher, ACL, defrag controller) at 10,000 mock nodes on the
     reference's fragmentation recipe (``tests/test_defrag.py``) scaled
     up: a filler job of one 3,000 MHz alloc a node, 40 thin jobs x 250
     allocs of 800 MHz / 512 MiB (one beside each filler), the filler
     deregistered; a fake client brings allocs up through
     ``update_allocs_from_client``. 100 nodes drained through
     ``update_node_drain`` (every alloc on them replaced by the
     scheduler's kernels, the nodes ineligible, none unaccounted for);
     then 4 defrag cycles called directly, each planned by the
     controller with the migration kernel on the server's card (A the
     candidates, at least 5,000; at most 512 moves; no node over
     capacity; every completed move the replacement / stopped-source
     pair; each thin job's live count unchanged; packing efficiency up),
     each kernel call timed by CUDA events, each cycle's host seconds
     split; every recorded ``migrate_plan`` call replayed through the
     kernel and the plain version (all six outputs identical); then the
     "server" path's bench again, with its admission block, gated the
     same way;
   - "resilience": the kernel guard (``backend.guarded_call``: breaker,
     chaos sites, watchdog deadline) in front of every launch, driven
     under faults on the port's server on the card: ``run_chaos`` under
     the default fault mix at 1,000 nodes x 100 steps (the reference's 200
     cut for time) for seeds 1, 2 and
     1 (every run ``ok``, every law checked or skipped for want of its
     state, seed 1's canonical reports identical and equal to the same
     run's on the CPU), the reference's migration-in-the-default-mix run,
     a kernel fault fired on a real launch, the closed-form and migration
     kernels launched, no call finished on a fallback; the degraded slice
     (hangs at 10 %: ``ok``, a trip, every refused eval accounted for);
     ``run_soak`` at bench.py soak's defaults on 10,000 nodes for 30 s
     (invariants clean, the SLO schema pinned, completions at least 0.8
     of arrivals, no trip, nothing swallowed); ``saturation_search`` at
     bench.py soak --saturation's defaults; and 1,000 synchronized
     ``place_closed_form`` calls at the schedule shape through the guard
     beside 1,000 straight (µs a call); each run's seconds, faults by
     kind, trips, refused calls, abandoned skips, nacks, unack timeouts,
     planned moves and launches logged. Every timing helper here launches
     straight through the guard (``backend.direct_launches``), so the
     kernels' times hold no guard;
   - "agent": the dev agent's front door, in two parts. (a) ``python -m
     nomad_tpu_torch.cli agent -dev --bind 127.0.0.1:0`` as a subprocess
     (its server's kernels on the card, the default): ``job run`` of an
     HCL batch job (3 x ``mock_driver``, 0.05 s) written by the script,
     ``job status`` until every alloc is ``complete``, then ``alloc
     status``, ``eval status`` and ``node status`` of the dev node, each a
     CLI process that must exit 0; the agent's own ``/v1/agent/trace``
     shows ``place_closed_form_kernel`` called, its node's ``gpu.type`` is
     the card's name and its device class follows from it, no call
     finished on a fallback, and it exits within 15 s of SIGINT. (b)
     ``DevAgent(device="cuda")`` and ``HTTPAgent(port=0)`` in process,
     the "server" path's 10,000 nodes seeded into the store and its
     warmup run, the dev node made ineligible through the API, its 100
     jobs x 250 registered through the SDK (one HTTP request a job), the
     evals drained and every job's allocations read back through the API:
     all 25,000 placed, no over-committed node, the API's allocations the
     store's, no fallback; allocs/s, eval p50 / p99, the register
     request's p50 / p99 at the client and the read-back's seconds logged
     beside the "server" path's allocs/s and p50; every closed-form and
     coupled call recorded and replayed;
   - "cluster": three server processes of one raft group on the card
     (``cluster_member``: this script run with ``--cluster-member``, an
     ``RPCServer`` and a ``ClusterServer(device="cuda", num_workers=1)``
     each, its kernel wrappers recorded for the process's life). The
     "server" path's 10,000 nodes registered over RPC through the three
     (one raft entry a node), its 100 jobs x 250 through a follower
     (each forwarded to the leader), placed by the leader on the card
     and replicated; the leader's recorded calls replayed in its own
     process; the leader killed (SIGKILL), a survivor elected, two more
     jobs (the recipe's, and one without its spread, for the closed
     form) registered through the remaining follower and placed by the
     new leader from a cold cache on the replicated store, its calls
     replayed; the killed member restarted on its data dir and caught
     up. Every member that led holds a kernel call or more, identical to
     plain; every alloc placed; no node over-committed in any store; the
     three stores' placements and latest index equal; no follower
     launched a kernel or built its cache; no fallback call; every
     member stopped. Each phase's seconds (election, nodes/s, allocs/s
     and eval p50 / p99 beside the "server" path's allocs/s, failover,
     the first placement after it, catch-up) and each process's launches
     logged;
   - "plugins": the client's out-of-process plugins (NDJSON over stdio)
     in one ``DevAgent(device="cuda", driver_mode="plugin",
     device_plugins=["torch"], csi_plugins=["hostpath"])``; each plugin's
     handshake and first answer timed as the agent starts it, with the
     card memory the ``torch`` device plugin's process takes. The dev node advertises
     the card as one ``nvidia/gpu/<name>`` group of
     ``torch.cuda.device_count()`` instances; a batch job asking that
     group runs a ``python -c`` task through the plugin driver, which sees
     ``CUDA_VISIBLE_DEVICES`` equal to its alloc's ``cuda-<k>`` and the
     card's name; a ``sleep 5`` task survives its driver plugin's SIGKILL
     and ends with exit code 0 through the respawned plugin; two batch
     allocs in turn share a hostpath CSI volume (the second reads what the
     first wrote; both unpublished when the client's GC tears them down);
     then the dev node ineligible, ``bench_torch``'s 10,000 nodes with an
     ``nvidia/gpu/a100-sxm4-80gb`` group of 8 on every 4th, and 16 service
     jobs x 100 allocs of one instance (half with a device affinity) and 4
     batch jobs x 50 of 8 placed through the device accounting into the
     closed form's ``slot_caps``: every alloc placed, no instance twice,
     every alloc's ids its node's group's, no node over-committed; its
     allocs/s, eval p50 / p99 and the device-cap pass's host ms an eval
     logged; every closed-form call recorded and replayed;
   - "mesh" (after "plugins"; every other path runs with
     ``NOMAD_TPU_MESH=off``): meshes built explicitly with ``cuda:0`` in
     every cell. (a) The closed form at ``bench.py kernel 100000 100
     10000 --mesh 2,4``'s size (131,072 padded nodes, 100 groups x 100)
     under 1x4, 2x2 and 2x4 and without a mesh, identical (uint32 views)
     to the one-device kernel and to plain; the shard launches', the
     merges' and the whole call's ms by graph replay beside their
     bounds, and each shard's form beside the unsharded call's. (b) The
     score matrix at G 100 there, sharded 1x4, identical. (c) The
     counterpart of ``__graft_entry__.dryrun_multichip`` at its sizes
     (the value scan on 10,240 nodes x 75 racks, the closed form on that
     batch, the 40,960-node region-major federation over 1x4),
     identical. (d) The schedule recipe through ``Harness(mesh=1x4)``,
     the score seam on, counted: the alloc -> node assignment of the run
     without a mesh; one node update re-uploads one shard refresh and
     no whole tensor, both device views copy back bitwise, a dropped
     shard refresh recovers by a whole upload; every recorded
     closed-form call identical to plain. (e) One ``run_chaos`` at the
     "resilience" size with the process mesh 1x4 and
     ``mesh.shard_refresh_drop`` scheduled: law 12's capacity half
     checked and passing. (f) The value scan, the chunked scan and the
     one-per-value scan alone at (a)'s 131,072 padded nodes (16 groups,
     250 racks) under 1x4, 2x2 and 2x4: identical to the one-device
     kernel and to plain, every launch a shard step, merge or apply
     (counted, none gathered), the call's ms and µs a step beside the
     one-device kernel's and its bound. (g) The "spread" recipe through
     ``Harness(mesh=1x4)``, counted apart ("mesh_spread"): the (job,
     node) counts of the run without a mesh, every coupled launch filed
     "shard" or "merge", no fallback call; then each mesh kernel of the
     coupled scans against its plain version on a step of one of its
     recorded one-per-value calls and of one of its chunked calls
     (the step loop counts each launch in C, where it launches). (h)
     The hetero pass (its three policies), the CP auction and its gang
     form alone at their batch paths' shapes (the "*_batch" paths' last
     recorded calls: 10,000 nodes, 16,384 padded; G 30, 100 and 300) under
     1x4, 2x2 and 2x4 (the makespan and cost policies under 1x4), laid
     out as the reference lays them: identical to the one-device kernel
     and to plain, every launch a shard step, merge or apply (counted in
     C, none gathered), the guarded call's seconds beside the execute
     deadline, the call's ms over 3 calls and µs a step or round. (i)
     The "hetero", "cp" and "gang" recipes through their kernel objects
     under ``Harness(mesh=1x4)``, counted apart ("mesh_plugins"): the
     (job, group, node) counts of the runs without a mesh, no gathered
     launch, none of the one-device auctions', no fallback call. (j)
     Each of their mesh kernels alone on (h)'s inputs cut into four node
     slices, against its plain version, timed by graph replay beside its
     bound. Distinct cards where there are several, else one line saying
     they were not exercised;
   - "spread": the JAX package's ``bench.py end_to_end`` node recipe
     (10,000 nodes over 25 racks, ssd on every 4th, every 3rd at
     8,000 MHz / 16,384 MiB) and 30 jobs through the Harness: its 20
     even rack spread + ssd affinity jobs x 250 (one-per-value kernel),
     5 target rack spread jobs x 250 (chunked kernel), 5
     distinct_property jobs x 200 capped at 10 per rack (value-scan
     kernel); the cut from bench.py's 100 jobs to 30 is for time;
   - "wide_values": on the spread path's cluster, one job per coupled
     route keyed on ``${node.unique.id}`` (V 16,384): the one-per-value
     kernel's working state does not fit in shared memory and runs from
     global scratch, the value scan and the chunked scan run the form
     their shape picks (a cluster, each block holding the 196 KB tables);
   - "preempt": 10,000 mock nodes filled by direct store upserts with
     3-6 ballast allocs each (600-1,200 MHz, 512-2,048 MiB, from batch
     jobs at priorities 20, 30 and 40 and a service at 75; under 1,000
     MHz left on every node), then, with service and batch preemption
     on, 20 service jobs at priority 80 and 4 batch jobs at priority 60,
     16 allocs of 1,000 MHz / 1,024 MiB each: every placement evicts
     (one choose-preemption-node launch per failed group, which carries
     the find pass at the path's V 8; the victims chosen on the host;
     each recorded call is replayed through the choice and through the
     find pass alone);
   - "system": on that cluster with the default configuration (system
     preemption on), one system job at priority 50 (500 MHz / 512 MiB)
     and one sysbatch job at priority 50 (one score-matrix launch per
     task group, victims chosen on the host);
   - "restore": that store saved with ``save_snapshot`` and restored
     with ``restore_snapshot`` (the restricted unpickler), every table
     the same size, then one new eval of 20 small allocs on the restored
     store and on the original: the same plan;
   - "hetero": 10,000 mock nodes on ``build_mixed_fleet``'s recipe (a
     seeded device class of tpu-v5e / tpu-v4 / gpu-a100 / cpu, 4,000 /
     8,000 / 16,000 MHz and 8,192 / 16,384 / 32,768 MiB by class index
     mod 3), 12 jobs with ``build_mixed_asks``'s throughput profiles, 250
     allocs of 500-2,000 MHz each, four under each of hetero-maxmin,
     hetero-makespan and hetero-cost (one hetero-greedy launch per eval);
   - "cp": on that cluster with cp-pack, 12 jobs of 3 groups x 40 allocs
     at ``build_cp_asks``'s asks (profile asks x 4, priorities 30 / 50 /
     80, every 4th job distinct_hosts): one CP launch and one
     score-matrix launch per eval (two where only some of its groups
     carry throughputs; the same on "gang", "cp_batch" and "gang_batch":
     one a ``build_cp_batch`` pass);
   - "gang": 10,000 mock nodes in 250 racks of 40 (pods of 10 racks, ici
     slices of half a rack) under a seeded 0-30 % ballast load, cp-gang,
     16 gang jobs of 3 groups x 4 allocs (even jobs colocate in a rack,
     odd jobs spread over pods), then a gang whose second group asks
     100,000 MHz and must release whole into one blocked eval;
   - "hetero_batch", "cp_batch", "gang_batch": the port's
     ``run_hetero_ab`` (10,000 nodes, 30 jobs x 100), ``run_cp_ab``
     (10,000 nodes, 100 jobs x 40) and ``run_gang_ab`` (64 nodes x 8
     jobs, and 10,000 nodes x 100 gang jobs of 3 groups);
   - "calib": the port's ``run_calib_ab`` at its defaults (1,000 mixed
     nodes, 12 jobs x 25; throughputs learned from synthetic execute
     spans through a flight recorder): its gate held and declared mode
     byte-identical, every hetero-greedy call replayed against plain;
   - "defrag": the port's ``run_defrag_ab`` at 10,000 nodes x 20,000
     allocs (``build_defrag_fleet``'s recipe: 4,000 MHz / 8,192 MiB
     nodes, allocs of 200/400/800 MHz and 512/1,024/2,048 MiB scattered
     one by one onto a random node with room), 512 moves a cycle, 4
     cycles, seed 42 (two kernel-vs-plain checks and one migration-auction
     launch a cycle), then at the reference's default size (48 x 96),
     where its recovery gate holds;
   every kernel call of each path is recorded, and after the counters
   are read each recorded call is replayed through the kernel and its
   plain version (choices and scores compared); every coupled,
   preemption, plugin and migration call's kernel is timed, and the last
   call of each kernel in full; the closed-form and score-matrix calls of
   every path that launches them are replayed the same way and their
   kernel time over each path taken from CUDA graphs of the recorded
   launches ("path_ms");
6. the port's parity suite (``device/parity.py``) at full size on the
   card: each coupled config's placements against the stepwise host
   oracle, within the reference's 0.5 % score bar;
7. the preemption kernels alone with seeded integer victims
   (``PREEMPT_PHASE_CASES``): at N 16,384 V 8 (the warp form, carried in
   the choice's launch), 32 and 33, 64 and 256 (a warp a row) and V 8
   with every key tied; V 256 tied and V 1,024 / 1,025 on 4,096 nodes
   (the last warp-a-row width, the first cluster one), 1,025 tied; V
   8,192 on 256 nodes and 32,768 on 64 (a row over a cluster); V 196,608
   on 8 nodes (the cluster form's capacity) and one past it (the
   global-scratch form); each case's form as the wrapper counted it at
   the launch, every output identical to the plain version, with the
   largest partial sum the outputs depend on checked below 2^24 (where
   float32 integer sums are exact in any order); then the choice's
   scratch protocol (calls back to back, graph replays between eager
   calls) and the graph nodes of a call (1 at V 8);
8. the plugin kernels alone at N 16,384 on seeded inputs, G 1, 30 and
   100 and a tie-heavy case (equal keys, scores and priorities,
   all-infeasible rows, -0.0 in used0), and for the hetero-greedy kernel
   negative cpu asks on every 4th group at G 30 and 100, G 1,024, G 8,192
   on 512 nodes (its state in global memory) and G 30 x 100 on 1,000
   nodes, whose preferred classes fill mid-pass; every output identical
   to the plain version, the hetero steps a launch and µs a step logged;
9. the migration-auction kernel alone at N 16,384 on seeded general
   inputs (scores that differ by row, random eligibility): A 20,000 at a
   budget of 512 and cut short after 2 rounds, A 2,000 at budgets 0, 1
   and A, a perturbed ``lam0``, tie-heavy cases (equal scores and
   gains, all-infeasible rows, -0.0 in used0 and lam0) at A 2,000 and
   256, and four cases of the kernel's early exit at A 2,000: every
   price positive, negative prices, each row's best node past a run of
   priced-out nodes longer than its candidate list, and ties exactly at
   the stop boundary; every output identical to the plain version;
10. the one-per-value kernel alone on the config-3 recipe at 10,000
   nodes: V + 1 = 33 and 257 (a lane over a thread-block cluster, value
   ids staged as uint8 and uint16), every 7th node without a value, and V
   4,096 (one block a lane from global scratch); identical to the plain
   version, its µs a step and blocks a lane logged;
11. the value scan and the chunked scan alone on the config-3 recipe at
   10,000 nodes (``CLUSTER_PHASE_CASES``): V + 1 = 33 and 257, every 7th
   node without a value, B = 2 with a distinct_property cap, a count
   that stops mid-chunk, all-tie scores, N 10,001, three lanes (a
   cluster of 8 blocks a lane each) and two blocks of 16,384 values (one
   block a lane from global scratch); identical to the plain version, µs
   a step and blocks a lane logged;
12. the "analysis" phase (the port's analysis plane on the card):
   ``python -m nomad_tpu_torch.analysis --json`` as a subprocess (exit
   0, no new source finding, the baseline's 28 fingerprints all still
   firing, no kernel finding over the 21 kernels); the kernel fleet
   (``analysis/kernellint/exercise.py``) twice on the card, the launch
   counters zeroed before the first run and read after it (each of the
   21 kernels launched at least once), every recorded call against its
   plain version on the same inputs (integers exactly, floats within
   ``MAX_ABS_ERR``), the second run equal to the first as uint32 views,
   no dtype but float32, int32 and bool/uint8 at any kernel's boundary;
   a third run inside ``retrace.budget_window()`` starting no build
   (each kernel's builds and budget logged); ``GET /v1/agent/trace``
   from an in-process API server whose ``kernel_fingerprints`` covers
   every kernel launched and equals ``fingerprint_table()``; and the
   "calib" path's ``added_retraces`` (0);
13. a ``[server]`` line with the summaries of "incremental", "batch"
   (its kernel ms beside the same evals' 10 calls one by one, and host
   seconds beside the incremental path's first off arm), "plan", "calib",
   "leader" (the drain, each defrag cycle's row, the bench with its
   admission block), "resilience", "agent", "cluster", "plugins",
   "restore" and "server", and a ``[mesh]`` line with the phase's; the
   total seconds with each group of phases' (a ``[time]`` line is logged
   as each group ends), one JSON line of per-kernel results,
   the card's name and power limit, then the device line last.

Times, kernels and plain versions alike, are device times per launch
from a CUDA-graph replay of 20 launches (3 for the coupled plain
versions, each thousands of small kernels), so no host launch cost sits
in either; "stream_ms" and "plain_stream_ms" are the same launched back
to back from Python. A coupled kernel's "bound_ms" counts the steps this
run's data made it take ("steps_per_launch"). The hetero-greedy kernel
is timed the same way, each captured launch with the copy and fills
that reset its outputs. The CP auction is a cooperative launch, not
captured in a graph: each of its 20 launches sits between its own pair
of CUDA events, its reset enqueued before the first, all queued behind a
sleep kernel, so neither the resets nor the host's launch overhead fall
inside a window. The plugin kernels' plain versions sync with the host
every step or round and are timed once. The gang path's kernel object
passes per-node coordinate ids (``cp_gang_place_ids``); those calls are
recorded and replayed, and phase 8 also holds the one-hot form
(``cp_gang_place``, the reference's signature) against its plain version.
The migration auction (a list-building launch, then a cooperative
launch of the rounds) is timed by ``queued_ms`` over 3 calls, both
launches of a call between its events; its plain version syncs with the
host every round and is timed once.

Tolerances: the kernels and their plain versions run the same IEEE
float32 operations in the same order (no FMA contraction, IEEE
division, the same libdevice ``expf``), so choices and fits must be
identical and scores agree within ``MAX_ABS_ERR`` (the coupled and
preemption kernels: exactly, on the integer-valued resources every path
gives them, where the prefix sums' order cannot matter; the plugin
and migration kernels: every output bit for bit, as the reference pins
its programs to its NumPy oracles). The parity
suite holds the coupled placements to the reference's own bar against
its oracle, ``|score_delta_pct| <= 0.5`` and no placement the oracle
made and the card did not.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import ctypes
import dataclasses
import importlib
import inspect
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from bench_torch import card_line, committed_overcommit

MAX_ABS_ERR = 1e-6
TIMED_LAUNCHES = 20
# ~50 ms at the H100's boost clock: longer than the host takes to queue
# TIMED_LAUNCHES launches with their resets behind it
QUEUE_SLEEP_CYCLES = 100_000_000
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3 (NVIDIA data sheet)
F32_OPS_PER_S = 67e12  # H100 SXM f32 outside the tensor cores (same sheet)
# f32 operations per feasible (g, n, j) candidate of the closed-form
# plane: (j+1), then per cpu/mem dim mul+add (proposed), sub, max, div
# (free fraction), mul (ln 10), exp, add (pow sum) = 16; binpack clip 3,
# fit div 1, collision add+compare 2, anti add+neg+max+div 4, numerator
# adds 3, denominator adds 3, final div 1, running min 1, order key 2
CLOSED_FORM_OPS_PER_CANDIDATE = 37
# f32 operations per (g, n) of the score matrix: 4 adds + 4 compares
# (fit test), per cpu/mem dim sub, max, div, mul, exp (10), pow sum add,
# clip 3, fit div 1, anti add+neg+max+div 4, component adds 3 and count
# adds 3, final div 1
SCORE_MATRIX_OPS_PER_CELL = 33
# f32 operations of one node's score in a coupled step, per value block
# (table lookup, select, boost add) and per node (fit and cap tests,
# boost-on test, numerator and denominator adds, division, argmax
# compare): 3 per block + 8
COUPLED_OPS_PER_BLOCK = 3
COUPLED_OPS_PER_NODE = 8
# f32 operations per (block, value) table entry and step (count add,
# min/max, target or even boost: sub, add, max, div, mul)
COUPLED_OPS_PER_TABLE_ENTRY = 8
# f32 operations per real victim of the preemption pass: the distance
# (per dimension sub, max, div, mul, add: 20; sqrt), the key (min, mul,
# add), the prefix adds (4) and the fit test (per dimension sub, add,
# compare: 12); and of the choice: the freed sum (4 per victim) and per
# node the two free fractions with their 10^x (sub, add, sub, max, div,
# mul, exp: 14), the fit (2 subs, clip 2, div) and the penalty (sub, div,
# exp, add, div) times the fit
PREEMPT_OPS_PER_VICTIM = 40
CHOOSE_OPS_PER_VICTIM = 4
CHOOSE_OPS_PER_NODE = 25
PARITY_BAR_PCT = 0.5
SPREAD_NODES = 10_000
SPREAD_RACKS = 25
DISTINCT_CAP = 10
PREEMPT_NODES = 10_000
# (priority, batch?) of the ballast jobs filling the preempt path's nodes
BALLAST = ((20, True), (30, True), (40, True), (75, False))
PREEMPTORS = ((80, False, 20), (60, True, 4))  # (priority, batch?, jobs)
PREEMPTOR_COUNT = 16
PREEMPTOR_ASK = (1000, 1024)  # MHz, MiB
SYSTEM_PRIORITY = 50
KERNEL_PHASE_NODES = 16_384
# integers up to 2^24 are exact in float32, and so is any sum of them
# whose partial sums all stay below it
EXACT_F32_INTEGERS = 2**24


def log(msg: str) -> None:
    print(msg, flush=True)


def direct_launches():
    """Kernel wrappers launch straight through the kernel guard inside
    the block (``backend.direct_launches``): every timing helper below
    measures a kernel alone, without the guard's watchdog hand-off and
    synchronize (the "resilience" path measures those apart)."""
    from nomad_tpu_torch.backend import direct_launches as direct

    return direct()


def cuda_ms(fn, iters: int = TIMED_LAUNCHES, warmup: int = 3) -> float:
    """Mean device time of ``fn`` over ``iters`` back-to-back launches,
    after a warm-up, measured with CUDA events."""
    with direct_launches():
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int = TIMED_LAUNCHES) -> float:
    """Mean device time of one ``fn`` launch: ``iters`` launches captured
    in a CUDA graph and replayed, so no host launch overhead sits between
    them (a kernel shorter than its Python wrapper would otherwise be
    timed at the host's launch rate). The warm-up call runs on the
    capture stream, so whatever a wrapper keeps per stream exists before
    the capture."""
    with direct_launches():
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            fn()
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, stream=side):
            for _ in range(iters):
                fn()
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / iters


def queued_ms(reset, launch, iters: int = TIMED_LAUNCHES, warmup: int = 3) -> float:
    """Mean device time of ``launch`` for a kernel a graph cannot capture:
    each launch between its own pair of CUDA events, its ``reset`` enqueued
    before the first event, and all of them queued behind a sleep kernel
    that holds the device until the host has enqueued them, so neither the
    resets nor the host's launch rate fall inside a window."""
    with direct_launches():
        for _ in range(warmup):
            reset()
            launch()
        torch.cuda.synchronize()
        pairs = [
            (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            for _ in range(iters)
        ]
        torch.cuda._sleep(QUEUE_SLEEP_CYCLES)
        for start, end in pairs:
            reset()
            start.record()
            launch()
            end.record()
        torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in pairs) / iters


def nbytes(*tensors) -> int:
    """Bytes of the tensors among ``tensors`` (static ints are skipped)."""
    return sum(
        t.numel() * t.element_size() for t in tensors if isinstance(t, torch.Tensor)
    )


# -- the headline inputs (the port's copy of bench.py's builders) -----------


def build_cluster(n_nodes: int, seed: int = 42):
    """Synthetic heterogeneous cluster (4/8/16-core classes, 0-40% load)."""
    from nomad_tpu_torch.device.flatten import ClusterTensors, node_bucket

    rng = np.random.default_rng(seed)
    pn = node_bucket(n_nodes)
    classes = rng.integers(0, 3, size=n_nodes)
    cpu = np.choose(classes, [4000, 8000, 16000]).astype(np.float32)
    mem = np.choose(classes, [8192, 16384, 32768]).astype(np.float32)
    capacity = np.zeros((pn, 4), dtype=np.float32)
    capacity[:n_nodes, 0] = cpu
    capacity[:n_nodes, 1] = mem
    capacity[:n_nodes, 2] = 100 * 1024
    capacity[:n_nodes, 3] = 1000
    used = np.zeros_like(capacity)
    load = rng.uniform(0.0, 0.4, size=(n_nodes, 1)).astype(np.float32)
    used[:n_nodes, :2] = capacity[:n_nodes, :2] * load
    ready = np.zeros(pn, dtype=bool)
    ready[:n_nodes] = True
    return ClusterTensors(
        node_ids=[f"node-{i}" for i in range(n_nodes)],
        index=1,
        num_nodes=n_nodes,
        capacity=capacity,
        used=used,
        ready=ready,
        dc_ids=np.pad(rng.integers(0, 3, n_nodes).astype(np.int32), (0, pn - n_nodes)),
        class_ids=np.pad(classes.astype(np.int32), (0, pn - n_nodes)),
        dc_vocab={"dc1": 0, "dc2": 1, "dc3": 2},
        class_vocab={"small": 0, "medium": 1, "large": 2},
        class_rep=[0, 1, 2],
        node_row={f"node-{i}": i for i in range(n_nodes)},
    )


def build_asks(ct, n_jobs: int, count_per_job: int, seed: int = 7):
    from nomad_tpu_torch.device.flatten import GroupAsk

    rng = np.random.default_rng(seed)
    pn = ct.padded_n
    asks = []
    for j in range(n_jobs):
        cpu = float(rng.choice([250, 500, 1000]))
        mem = float(rng.choice([256, 512, 1024]))
        asks.append(
            GroupAsk(
                job_id=f"job-{j}",
                tg_name="web",
                count=count_per_job,
                desired_total=count_per_job,
                ask=np.array([cpu, mem, 300.0, 0.0], dtype=np.float32),
                eligible=ct.ready.copy(),
                job_counts=np.zeros(pn, dtype=np.int32),
                penalty_nodes=np.zeros(pn, dtype=bool),
                affinity_scores=np.zeros(pn, dtype=np.float32),
                has_affinities=False,
                distinct_hosts=False,
            )
        )
    return asks


def device_batch(ct, asks, dev):
    """The kernel inputs exactly as PlacementKernel assembles them."""
    from nomad_tpu_torch.device import score as S

    kern = S.PlacementKernel(device=dev)
    max_j = kern._max_j(ct, asks)
    k = S._steps_bucket(max(a.count for a in asks) + S.OVERFLOW_CANDIDATES)
    lanes = S._pad_group_axis(list(asks), ct.padded_n)
    b = S._device_batch(S._shared_batch(lanes, ct.padded_n), dev)
    b["capacity"] = torch.from_numpy(ct.capacity).to(dev)
    b["used0"] = torch.from_numpy(ct.used).to(dev)
    return b, max_j, k


def closed_form_args(b):
    order = (
        "capacity", "used0", "asks", "eligible", "job_counts",
        "desired_totals", "penalty_nodes", "affinity_scores",
        "has_affinities", "distinct_hosts", "slot_caps",
    )
    return [b[key] for key in order]


# -- phase 2 -----------------------------------------------------------------


def launched_form(launch):
    """Runs ``launch``, one closed-form call, and returns its result and
    the form it launched as the wrapper counted it at the launch
    (``place_closed_form.forms``: blocks a lane, 1 the one-block form)."""
    from nomad_tpu_torch.device import score as S

    forms = S.place_closed_form.forms
    forms.clear()
    out = launch()
    assert sum(forms.values()) == 1, f"closed form: one call launched {forms}"
    (blocks,) = forms
    return out, blocks


def check_closed_form(name, args, spread, max_j, k, jitter, timed):
    from nomad_tpu_torch.device import score as S

    (ch, sc), blocks = launched_form(
        lambda: S.place_closed_form(*args, spread, max_j, k, jitter)
    )
    chp, scp = S.place_closed_form_plain(*args, spread, max_j, k, jitter)
    torch.cuda.synchronize()
    mismatches = int((ch != chp).sum())
    fin = torch.isfinite(scp)
    inf_agree = bool(torch.equal(torch.isfinite(sc), fin))
    err = float((sc - scp).abs()[fin].max()) if bool(fin.any()) else 0.0
    picked = ch[ch >= 0]
    assert picked.numel() > 0, f"closed_form {name}: nothing placed"
    out = {
        "max_abs_err": err,
        "choice_mismatches": mismatches,
        "inf_agree": inf_agree,
        "lowest_row": int(picked.min()),
        "nodes_picked": int(torch.unique(picked).numel()),
        "placed_slots": int(picked.numel()),
        "blocks_per_lane": blocks,
    }
    log(
        f"[closed_form:{name}] G={args[2].shape[0]} N={args[0].shape[0]} "
        f"J={max_j} k={k} form S={out['blocks_per_lane']} placed_slots={picked.numel()} on "
        f"{out['nodes_picked']} nodes from row {out['lowest_row']} "
        f"choice_mismatches={mismatches} max_abs_err={err!r} inf_agree={inf_agree}"
    )
    assert mismatches == 0, f"closed_form {name}: choices differ from plain"
    assert inf_agree, f"closed_form {name}: infeasible slots differ"
    assert err <= MAX_ABS_ERR, f"closed_form {name}: |err| {err} > {MAX_ABS_ERR}"
    if timed:
        launch = lambda: S.place_closed_form(*args, spread, max_j, k, jitter)  # noqa: E731
        plain = lambda: S.place_closed_form_plain(*args, spread, max_j, k, jitter)  # noqa: E731
        out["ms"] = graph_ms(launch)
        out["stream_ms"] = cuda_ms(launch)
        out["plain_ms"] = graph_ms(plain)
        out["plain_stream_ms"] = cuda_ms(plain)
        # the work this run's data needs: feasible candidates of the plane
        num, den, fits = S._score_planes(
            *args[:11], spread, max_j, jitter=jitter
        )
        feasible = int(fits.sum())
        del num, den, fits
        g, n = args[3].shape
        in_bytes = nbytes(*args, jitter)
        out_bytes = g * k * 8
        t_bytes = (in_bytes + out_bytes) / HBM_BYTES_PER_S * 1e3
        t_ops = feasible * CLOSED_FORM_OPS_PER_CANDIDATE / F32_OPS_PER_S * 1e3
        out["bound_ms"] = max(t_bytes, t_ops)
        out["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
        out["feasible_candidates"] = feasible
        out["plane_candidates"] = g * n * max_j
        log(
            f"[closed_form:{name}] kernel_ms={out['ms']!r} plain_ms="
            f"{out['plain_ms']!r} (graph replay; back to back on the stream "
            f"{out['stream_ms']!r} and {out['plain_stream_ms']!r}) bound_ms="
            f"{out['bound_ms']!r} ({out['bound_by']}; {feasible} feasible of "
            f"{g * n * max_j} candidates)"
        )
    return out


# the schedule path's pass: mock nodes (3,900 MHz / 7,936 MiB after the
# reserved carve-out), 500 MHz / 256 MiB asks, J 16, k 1,024
SCHEDULE_CAPACITY = (3900.0, 7936.0, 98304.0, 1000.0)
SCHEDULE_ASK = (500.0, 256.0, 300.0, 0.0)
SCHEDULE_J = 16
SCHEDULE_K = 1024


def schedule_inputs(dev, g=1, n_nodes=10_000, seed=0, k=SCHEDULE_K, pad=True):
    """Closed-form inputs shaped like the schedule path's later passes, at
    G lanes: identical mock nodes padded to a power of two, the first
    1,000 full, the next 1,900 holding two allocs and 100 after them three
    (so the top k hold 100 heads above one class of 1,900 tied heads, and
    the ties taken, rows 1,000 to 1,923, straddle the boundary at 1,024 of
    a lane's 16 slices), the rest empty. Each lane asks
    500 or 1,000 MHz and holds one earlier alloc of its job on a window of
    rows of its own, so the lanes differ. ``pad=False`` keeps N = n_nodes.
    Returns (args, max_j, k)."""
    from nomad_tpu_torch.device.flatten import node_bucket

    rng = np.random.default_rng(seed)
    pn = node_bucket(n_nodes) if pad else n_nodes
    cap = np.zeros((pn, 4), np.float32)
    cap[:n_nodes] = SCHEDULE_CAPACITY
    used = np.zeros((pn, 4), np.float32)
    one = np.array(SCHEDULE_ASK, np.float32)
    used[:1000] = 7 * one
    used[1000:2900] = 2 * one
    used[2900:3000] = 3 * one
    asks = np.tile(one, (g, 1))
    asks[1:, 0] = rng.choice([500.0, 1000.0], g - 1)
    eligible = np.zeros((g, pn), bool)
    eligible[:, :n_nodes] = True
    job_counts = np.zeros((g, pn), np.int32)
    for i in range(1, g):
        lo = int(rng.integers(3000, n_nodes - 500))
        job_counts[i, lo:lo + 500] = 1
    arrays = {
        "capacity": cap, "used0": used, "asks": asks, "eligible": eligible,
        "job_counts": job_counts,
        "desired_totals": np.full(g, 1000.0, np.float32),
        "penalty_nodes": np.zeros((g, pn), bool),
        "affinity_scores": np.zeros((g, pn), np.float32),
        "has_affinities": np.zeros(g, bool),
        "distinct_hosts": np.zeros(g, bool),
        "slot_caps": np.full((g, pn), np.inf, np.float32),
    }
    return (
        [torch.from_numpy(np.ascontiguousarray(arrays[key])).to(dev)
         for key in CLOSED_FORM_INPUTS],
        SCHEDULE_J, k,
    )


# phase 2's sweep: the schedule pass at each lane count, then the edges
CLOSED_FORM_SWEEP_G = (1, 2, 4, 8, 16, 32, 64, 128, 256)


def closed_form_edges(dev):
    """(label, args, spread, max_j, k, jitter) of phase 2's edge cases, on
    the schedule pass's shape at G 1 unless named."""
    out = []
    args, j, k = schedule_inputs(dev, 1, k=8192)
    out.append(("k 8,192 (k_eff above 4,096)", args, False, j, k, None))
    args, j, k = schedule_inputs(dev, 4, k=16384)
    out.append(("G 4, k 16,384", args, False, j, k, None))
    args, j, k = schedule_inputs(dev, 1)
    args[3] = args[3].clone()
    args[3][:, 1300:] = False  # 300 rows with room: 1,500 slots
    out.append(("k above the finite picks (-inf slots)", args, False, j, 2048, None))
    args, j, k = schedule_inputs(dev, 2, n_nodes=10_001, pad=False)
    out.append(("N 10,001 (not a multiple of S)", args, False, j, k, None))
    args, j, k = schedule_inputs(dev, 1, n_nodes=262_144)
    out.append(("N 262,144 (a block's share past shared memory: one block a lane)",
                args, False, j, k, None))
    args, j, k = schedule_inputs(dev, 1)
    args[4] = torch.ones_like(args[4])  # one earlier alloc on every node
    args[5] = torch.full_like(args[5], 1e30)  # anti-affinity below an ulp
    args[0] = args[0].clone()
    args[1] = torch.zeros_like(args[1])  # identical empty nodes
    out.append(("flat all-tie columns", args, False, j, k, None))
    args, j, k = schedule_inputs(dev, 1, k=1)
    out.append(("k 1", args, False, j, k, None))
    args, j, k = schedule_inputs(dev, 1)
    rows = np.arange(args[0].shape[0], dtype=np.int64)
    h = (rows * 2654435761 + 40503) & 0xFFFFFFFF
    jitter = torch.from_numpy(((h % 65536).astype(np.float32) / 65536.0) * 2e-5).to(dev)
    out.append(("jitter", args, False, j, k, jitter))
    args, j, k = schedule_inputs(dev, 1)
    out.append(("spread algorithm", args, True, j, k, None))
    args, j, k = schedule_inputs(dev, 8)
    args[9] = torch.ones_like(args[9])  # distinct_hosts on every lane
    out.append(("G 8 distinct_hosts", args, False, j, k, None))
    # the "agent" path's subprocess pass: its one dev node padded to
    # node_bucket(1), empty, AGENT_JOB_HCL's ask (count 3), J 32, k 16,
    # so most of the lane's blocks get no rows
    args, _, _ = schedule_inputs(dev, 1, n_nodes=1)
    args[1] = torch.zeros_like(args[1])
    args[2] = torch.tensor([[100.0, 64.0, 300.0, 0.0]], device=dev)
    args[5] = torch.full_like(args[5], 3.0)
    out.append(("the dev agent's pass (one node padded to 8, J 32, k 16)",
                args, False, 32, 16, None))
    return out


def closed_form_sweep(dev):
    """Phase 2's sweep: the schedule pass at G 1 to 256, the edge cases
    and G 64 in 2 blocks a lane, each identical to plain (choices, scores
    bit for bit, -inf in the same slots), with the form it launched, its
    ms by graph replay and its bound."""
    out = {}
    for g in CLOSED_FORM_SWEEP_G:
        args, max_j, k = schedule_inputs(dev, g)
        r = check_closed_form(f"sweep G={g}", args, False, max_j, k, None, timed=True)
        out[f"G={g}"] = {key: r[key] for key in SWEEP_KEYS}
    for label, args, spread, max_j, k, jitter in closed_form_edges(dev):
        r = check_closed_form(f"edge {label}", args, spread, max_j, k, jitter, timed=True)
        out[label] = {key: r[key] for key in SWEEP_KEYS}
    # 2 blocks a lane, a size the rule picks only where no cluster of 4
    # can be resident, asked for at G 64
    from nomad_tpu_torch.device import score as S

    plan = S.closed_form_plan
    S.closed_form_plan = lambda g, n, kpad: plan(g, n, kpad, 2)
    try:
        args, max_j, k = schedule_inputs(dev, 64)
        r = check_closed_form("G=64 asking for S=2", args, False, max_j, k, None, timed=True)
    finally:
        S.closed_form_plan = plan
    out["G=64 asking for S=2"] = {key: r[key] for key in SWEEP_KEYS}
    forms_run = {r["blocks_per_lane"] for r in out.values()}
    assert {1, 2, 4, 8, 16} <= forms_run, f"closed form: phase 2 ran only forms {forms_run}"
    bits = all(r["max_abs_err"] == 0.0 and r["choice_mismatches"] == 0 and r["inf_agree"]
               for r in out.values())
    assert bits, "closed form: a phase 2 case differs from plain"
    forms = ", ".join(f"{case}: S={r['blocks_per_lane']}" for case, r in out.items())
    log(f"[closed_form] phase 2: {len(out)} sweep and edge cases identical to plain; "
        f"forms {forms}")
    return out


SWEEP_KEYS = ("blocks_per_lane", "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err",
              "choice_mismatches", "inf_agree", "placed_slots")


def extras_case(dev):
    """A smaller case with every closed-form component non-trivial."""
    ct = build_cluster(2000, seed=3)
    asks = build_asks(ct, 12, 60, seed=5)
    rng = np.random.default_rng(11)
    pn = ct.padded_n
    for i, a in enumerate(asks):
        a.job_counts = (
            (rng.random(pn) < 0.2) * rng.integers(1, 3, pn)
        ).astype(np.int32) * ct.ready
        a.penalty_nodes = (rng.random(pn) < 0.05) & ct.ready
        a.has_affinities = True
        a.affinity_scores = (
            rng.choice([-0.5, 0.0, 0.5], pn).astype(np.float32) * ct.ready
        )
        a.slot_caps = np.where(
            rng.random(pn) < 0.3, rng.integers(0, 4, pn), np.inf
        ).astype(np.float32)
        a.distinct_hosts = i % 4 == 0
    b, max_j, k = device_batch(ct, asks, dev)
    rows = np.arange(pn, dtype=np.int64)
    h = (rows * 2654435761 + 40503) & 0xFFFFFFFF
    jitter = torch.from_numpy(
        ((h % 65536).astype(np.float32) / 65536.0) * 2e-5
    ).to(dev)
    return closed_form_args(b), max_j, k, jitter


# -- phase 3 -----------------------------------------------------------------


def check_score_matrix(name, args, spread, tp, timed):
    from nomad_tpu_torch.device import score as S

    f, fits = S.score_matrix(*args, spread, tp)
    fp, fitsp = S.component_scores(*args, spread, tp)
    torch.cuda.synchronize()
    fits_mismatch = int((fits != fitsp).sum())
    fin = torch.isfinite(fp)
    inf_agree = bool(torch.equal(torch.isfinite(f), fin))
    err = float((f - fp).abs()[fin].max()) if bool(fin.any()) else 0.0
    log(
        f"[score_matrix:{name}] G={args[2].shape[0]} N={args[0].shape[0]} "
        f"feasible={int(fitsp.sum())} fits_mismatches={fits_mismatch} "
        f"max_abs_err={err!r} inf_agree={inf_agree}"
    )
    assert fits_mismatch == 0 and inf_agree, f"score_matrix {name}: fits differ"
    assert err <= MAX_ABS_ERR, f"score_matrix {name}: |err| {err} > {MAX_ABS_ERR}"
    out = {"max_abs_err": err, "choice_mismatches": fits_mismatch}
    if timed:
        launch = lambda: S.score_matrix(*args, spread, tp)  # noqa: E731
        plain = lambda: S.component_scores(*args, spread, tp)  # noqa: E731
        out["ms"] = graph_ms(launch)
        out["stream_ms"] = cuda_ms(launch)
        out["plain_ms"] = graph_ms(plain)
        out["plain_stream_ms"] = cuda_ms(plain)
        out["bound_ms"], out["bound_by"] = score_matrix_bound(args, tp)
        log(
            f"[score_matrix:{name}] kernel_ms={out['ms']!r} plain_ms="
            f"{out['plain_ms']!r} (graph replay; back to back on the stream "
            f"{out['stream_ms']!r} and {out['plain_stream_ms']!r}) bound_ms="
            f"{out['bound_ms']!r} ({out['bound_by']})"
        )
    return out


def score_matrix_bound(args, tp) -> tuple:
    """(bound_ms, bound_by) of one score-matrix call: its inputs read once
    and its outputs (f32 and a byte a cell) written once over the card's
    memory rate, or its f32 operations over the peak rate."""
    g, n = args[3].shape
    t_bytes = (nbytes(*args, tp) + g * n * 5) / HBM_BYTES_PER_S * 1e3
    t_ops = g * n * SCORE_MATRIX_OPS_PER_CELL / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def score_matrix_inputs(b, dev):
    rng = np.random.default_rng(13)
    g, n = b["eligible"].shape
    jc = torch.from_numpy(
        ((rng.random((g, n)) < 0.2) * rng.integers(1, 3, (g, n))).astype(np.int32)
    ).to(dev)
    pen = torch.from_numpy(rng.random((g, n)) < 0.05).to(dev)
    aff = torch.from_numpy(
        rng.choice([-0.5, 0.0, 0.5], (g, n)).astype(np.float32)
    ).to(dev)
    haff = torch.from_numpy(rng.random(g) < 0.5).to(dev)
    dh = torch.from_numpy(rng.random(g) < 0.25).to(dev)
    tp = torch.from_numpy(
        rng.choice([0.0, 0.25, 0.5, 1.0], (g, n)).astype(np.float32)
    ).to(dev)
    args = [
        b["capacity"], b["used0"], b["asks"], b["eligible"], jc,
        b["desired_totals"], pen, aff, haff, dh,
    ]
    return args, tp


SCORE_MATRIX_GROUPS = (1, 3, 100)


def score_matrix_by_g(args, dev):
    """Phase 3's score matrix at G 1, 3 and 100: the headline inputs' first
    G groups, each against its plain version, timed."""
    return {
        g: check_score_matrix(
            f"G={g}", [a if i < 2 else a[:g].contiguous() for i, a in enumerate(args)],
            False, None, timed=True,
        )
        for g in SCORE_MATRIX_GROUPS
    }


def cp_batch_scoring(dev):
    """Phase 3's batched pass: ``build_cp_batch`` at the cp_batch path's
    shape (``run_cp_ab``'s fleet and asks: 10,000 nodes, 100 jobs) against
    the per-ask ``score_group`` loop it replaced, on the card: the same
    scores (bit for bit) and eligibility, from one score-matrix launch
    (two with mixed throughputs). Host seconds of both logged."""
    from nomad_tpu_torch.device import score_triton as ST
    from nomad_tpu_torch.scheduler import cp as SC
    from nomad_tpu_torch.scheduler import hetero as H
    from nomad_tpu_torch.scheduler.algorithms import score_group

    ct = H.build_mixed_fleet(PLUGIN_NODES, seed=42)
    asks = SC.build_cp_asks(ct, 100, 40, seed=42)
    zero_counters()
    t0 = time.perf_counter()
    with cp_batches() as want:
        batch = SC.build_cp_batch(ct, asks, device=dev)
    batch_s = time.perf_counter() - t0
    launches = ST.score_matrix_triton.launches
    t0 = time.perf_counter()
    rows = [score_group(ct, a, float(a.desired_total), device=dev) for a in asks]
    loop_s = time.perf_counter() - t0
    scores = np.stack([np.where(fits, finals, np.float32(0.0)) for finals, fits in rows])
    eligible = np.stack([a.eligible for a in asks]) & np.stack([fits for _, fits in rows])
    mismatches = int((batch.scores.view(np.uint32) != scores.view(np.uint32)).sum()) + int(
        (batch.eligible != eligible).sum()
    )
    log(
        f"[score_matrix:cp batch] G={len(asks)} N={ct.padded_n}: {launches} launches "
        f"(want {sum(want)}), mismatches against the per-ask loop {mismatches}; host "
        f"seconds batched {batch_s!r}, per-ask loop {loop_s!r} ({len(asks)} launches)"
    )
    assert launches == sum(want) and len(want) == 1 and launches in (1, 2), (launches, want)
    assert mismatches == 0, "build_cp_batch: the batched rows differ from score_group's"
    return {"launches": launches, "groups": len(asks), "choice_mismatches": mismatches,
            "host_s": batch_s, "per_ask_host_s": loop_s}


# -- phases 4 and 5 -----------------------------------------------------------


def cross_device_check(dev):
    """The same small scheduling run on the card and on the CPU must
    place the same nodes with the same scores: service jobs, then an
    even rack spread, a target rack spread and a distinct_property job
    (each coupled kernel once)."""
    from nomad_tpu_torch import interop, mock
    from nomad_tpu_torch.scheduler import Harness
    from nomad_tpu_torch.structs import Constraint, Spread, SpreadTarget

    nodes = []
    for i in range(300):
        n = mock.node()
        n.attributes["platform.rack"] = f"r{i % 10}"
        n.compute_class()
        nodes.append(n)
    rack = "${attr.platform.rack}"
    jobs = []
    for count, spreads, constraints in (
        (150, [], []),
        (90, [], []),
        (400, [], []),
        (80, [Spread(attribute=rack, weight=50)], []),
        (60, [Spread(attribute=rack, weight=50, targets=[
            SpreadTarget(value=f"r{r}", percent=30) for r in range(3)
        ])], []),
        (40, [], [Constraint(l_target=rack, r_target="5", operand="distinct_property")]),
    ):
        j = mock.job()
        j.task_groups[0].count = count
        j.spreads = spreads
        j.task_groups[0].constraints.extend(constraints)
        jobs.append(j)
    recs = (
        [dataclasses.asdict(n) for n in nodes],
        [dataclasses.asdict(j) for j in jobs],
        [],
    )
    views = []
    for device in (dev, "cpu"):
        h = Harness(interop.store_from_records(*recs), device=device)
        for j in jobs:
            ev = mock.eval_for(j, id=f"eval-{j.id}")
            h.store.upsert_evals(h.next_index(), [ev])
            h.process(ev)
        views.append(
            sorted(
                (a.job_id, a.node_id, float(v))
                for a in h.store.allocs()
                for v in a.metrics.scores.values()
            )
        )
    card, cpu = views
    assert [v[:2] for v in card] == [v[:2] for v in cpu], (
        "card and CPU runs placed differently"
    )
    err = max(abs(a[2] - b[2]) for a, b in zip(card, cpu))
    assert err <= MAX_ABS_ERR, f"card and CPU scores differ by {err}"
    log(
        f"[cross_device] 300 nodes, {len(jobs)} jobs (3 service, even spread, "
        f"target spread, distinct_property): {len(card)} allocs on the same "
        f"nodes on card and CPU, max score difference {err!r}"
    )


class Recorder:
    """Stands in for a kernel wrapper ``module.name`` while a path runs and
    keeps the arguments of every call, so that the path's own kernel
    inputs can be replayed against the plain version once its launch
    counters have been read. The wrapper itself still runs each call and
    counts it: it bumps ``<its name>.launches`` through the module global,
    which is this object while it stands in, so every counter read or set
    on it (``launches``, ``carried``) is the wrapper's own. A call to a
    wrapper that counts its forms (the closed form, the find pass) also
    keeps the forms it launched (``launched_forms``, from the wrapper's
    ``forms`` count). Calls pass through one at a time (a lock): the
    server's worker and its commit thread may call a wrapper at once, and
    a call's launched forms are the count's change across that call
    alone."""

    def __init__(self, real):
        self.real = real
        self.sig = inspect.signature(real)
        self.calls = []
        self.lock = threading.Lock()

    def __call__(self, *args, **kwargs):
        bound = self.sig.bind(*args, **kwargs)
        bound.apply_defaults()
        call = dict(bound.arguments)
        with self.lock:
            self.calls.append(call)
            forms = getattr(self.real, "forms", None)  # the closed form's, by blocks a lane
            before = dict(forms or {})
            out = self.real(*args, **kwargs)
            if forms is not None:  # what this call launched, as the wrapper counted it
                call["launched_forms"] = {
                    s: n - before.get(s, 0) for s, n in forms.items() if n != before.get(s, 0)
                }
        return out

    def __getattr__(self, name):  # the wrapper's counters
        return getattr(self.real, name)

    def __setattr__(self, name, value):  # ... are set on the wrapper itself
        if name in ("real", "sig", "calls", "lock"):
            object.__setattr__(self, name, value)
        else:
            setattr(self.real, name, value)


class TimedRecorder(Recorder):
    """A ``Recorder`` that also times each call on the card: between two
    CUDA events on the current stream around the wrapper ("event_ms",
    the wrapper's launches and any host work between them), and on the
    host clock ("host_s", the wait for the card included)."""

    def __call__(self, *args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        t0 = time.perf_counter()
        start.record()
        out = super().__call__(*args, **kwargs)
        end.record()
        end.synchronize()
        self.calls[-1].update(
            event_ms=start.elapsed_time(end), host_s=time.perf_counter() - t0
        )
        return out


@contextlib.contextmanager
def recording(module, name, cls=Recorder):
    rec = cls(getattr(module, name))
    setattr(module, name, rec)
    try:
        yield rec.calls
    finally:
        setattr(module, name, rec.real)


@contextlib.contextmanager
def timing(module, name, seconds: dict):
    """Stands in for the host function ``module.name`` while a path runs
    and adds the host-clock seconds of its calls (device work it waits
    for included) to ``seconds[name]``."""
    real = getattr(module, name)

    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return real(*args, **kwargs)
        finally:
            seconds[name] = seconds.get(name, 0.0) + time.perf_counter() - t0

    setattr(module, name, timed)
    try:
        yield seconds
    finally:
        setattr(module, name, real)


# the coupled kernels' wrappers, by the kernel.place span tag of their route
COUPLED = {
    "place_spread_opv": "opv",
    "place_spread_chunked": "chunked",
    "place_value_scan": "scan",
}


# the coupled scans' kernels under a node-axis mesh (their wrappers in
# nomad_tpu_torch.device.score)
MESH_COUPLED = ("coupled_shard_step", "coupled_step_merge", "coupled_shard_apply")
# the hetero pass's and the CP auction's kernels under a node-axis mesh,
# by their wrappers' modules
MESH_PLUGIN = {
    "hetero_shard_step": "nomad_tpu_torch.scheduler.hetero",
    "hetero_step_merge": "nomad_tpu_torch.scheduler.hetero",
    "hetero_shard_apply": "nomad_tpu_torch.scheduler.hetero",
    "cp_shard_claim": "nomad_tpu_torch.device.cp",
    "cp_round_merge": "nomad_tpu_torch.device.cp",
    "cp_shard_settle": "nomad_tpu_torch.device.cp",
}


# the preemption kernels' wrappers in nomad_tpu_torch.device.preempt
PREEMPT = ("find_preemption", "choose_preemption_node")
# the find passes carried inside the choice's launch (V <= 32), counted
# apart from find_preemption's own launches
CARRIED = "find_preemption_carried"
PREEMPT_COUNTS = (*PREEMPT, CARRIED)


def counters() -> dict:
    from nomad_tpu_torch.device import preempt as P
    from nomad_tpu_torch.device import score as S
    from nomad_tpu_torch.device import score_triton as ST

    return {
        "place_closed_form": S.place_closed_form.launches,
        "closed_form_topk_merge": S.closed_form_topk_merge.launches,
        **{name: getattr(S, name).launches for name in MESH_COUPLED},
        "score_matrix": ST.score_matrix_triton.launches,
        **{name: getattr(S, name).launches for name in COUPLED},
        **{name: getattr(P, name).launches for name in PREEMPT},
        CARRIED: P.find_preemption.carried,
        **{name: getattr(plugin_module(name), name).launches for name in PLUGIN},
        **{name: getattr(importlib.import_module(m), name).launches
           for name, m in MESH_PLUGIN.items()},
        "migrate_plan": migrate_module().migrate_plan.launches,
    }


def zero_counters() -> None:
    from nomad_tpu_torch.device import preempt as P
    from nomad_tpu_torch.device import score as S
    from nomad_tpu_torch.device import score_triton as ST

    S.place_closed_form.launches = 0
    S.place_closed_form.forms.clear()
    S.closed_form_topk_merge.launches = 0
    for name in MESH_COUPLED:
        getattr(S, name).launches = 0
    ST.score_matrix_triton.launches = 0
    for name in COUPLED:
        getattr(S, name).launches = 0
    for name in PREEMPT:
        getattr(P, name).launches = 0
    P.find_preemption.carried = 0
    P.find_preemption.forms.clear()
    for name in PLUGIN:
        getattr(plugin_module(name), name).launches = 0
    for name, m in MESH_PLUGIN.items():
        getattr(importlib.import_module(m), name).launches = 0
    migrate_module().migrate_plan.launches = 0


CLOSED_FORM_INPUTS = (
    "capacity", "used0", "asks", "eligible", "job_counts", "desired_totals",
    "penalty_nodes", "affinity_scores", "has_affinities", "distinct_hosts",
    "slot_caps",
)
SCORE_MATRIX_INPUTS = (
    "capacity", "used", "asks", "eligible", "job_counts", "desired_totals",
    "penalty_nodes", "affinity_scores", "has_affinities", "distinct_hosts",
)


def replay_closed_form(calls):
    """Every closed-form launch of the schedule path, through the kernel
    and the plain version on the same inputs; the last one timed."""
    worst = {"max_abs_err": 0.0, "choice_mismatches": 0}
    for i, c in enumerate(calls):
        last = i == len(calls) - 1
        out = check_closed_form(
            f"schedule pass {i}", [c[key] for key in CLOSED_FORM_INPUTS],
            c["algorithm_spread"], c["max_j"], c["k"], c["jitter"], timed=last,
        )
        worst["max_abs_err"] = max(worst["max_abs_err"], out["max_abs_err"])
        worst["choice_mismatches"] += out["choice_mismatches"]
    # the timed pass is the last eval's: earlier jobs have filled the
    # lowest rows, so its picks start past one 512-row compaction round
    # and its k-th key lies inside the tie class of the empty nodes
    assert out["lowest_row"] >= 512, out["lowest_row"]
    g, n = c["eligible"].shape
    out.update(worst)
    out["shape"] = f"G={g} N={n} J={c['max_j']} k={c['k']} (last schedule pass)"
    return out


def replay_score_matrix(calls, path="score_group"):
    """Every score-matrix launch of a path, through the kernel and the
    plain version on the same inputs; the last one timed."""
    worst = {"max_abs_err": 0.0, "choice_mismatches": 0}
    for i, c in enumerate(calls):
        out = check_score_matrix(
            f"{path} call {i}", [c[key] for key in SCORE_MATRIX_INPUTS],
            c["algorithm_spread"], c["throughputs"], timed=i == len(calls) - 1,
        )
        worst["max_abs_err"] = max(worst["max_abs_err"], out["max_abs_err"])
        worst["choice_mismatches"] += out["choice_mismatches"]
    g, n = c["eligible"].shape
    out.update(worst)
    out["shape"] = f"G={g} N={n} (last {path} call)"
    return out


# the closed-form and score-matrix calls of the paths that do not replay
# them as their own kernel's, by path
SHARED_CALLS: dict = {}
CALLS_GRAPHED = 256  # recorded launches captured in one CUDA graph


@contextlib.contextmanager
def shared_recording(path, closed_form=True, score_matrix=True):
    """Records ``path``'s closed-form and score-matrix calls into
    ``SHARED_CALLS[path]``, for ``replay_shared``."""
    from nomad_tpu_torch.device import score as S
    from nomad_tpu_torch.device import score_triton as ST

    with contextlib.ExitStack() as stack:
        rec = {}
        if closed_form:
            rec["place_closed_form"] = stack.enter_context(recording(S, "place_closed_form"))
        if score_matrix:
            rec["score_matrix"] = stack.enter_context(recording(ST, "score_matrix_triton"))
        yield
    SHARED_CALLS[path] = rec


def shared_launch(name, c, plain=False):
    """A callable running one recorded closed-form or score-matrix call
    through the kernel (or with ``plain`` its plain version)."""
    from nomad_tpu_torch.device import score as S

    if name == "place_closed_form":
        args = [c[key] for key in CLOSED_FORM_INPUTS]
        fn = S.place_closed_form_plain if plain else S.place_closed_form
        return lambda: fn(*args, c["algorithm_spread"], c["max_j"], c["k"], c["jitter"])
    args = [c[key] for key in SCORE_MATRIX_INPUTS]
    fn = S.component_scores if plain else S.score_matrix
    return lambda: fn(*args, c["algorithm_spread"], c["throughputs"])


def calls_ms(launches):
    """Device ms of the callables' launches together: ``CALLS_GRAPHED`` at a
    time captured in one CUDA graph and replayed between two events (each
    graph replayed once before), as ``graph_ms`` times one call's launches,
    so no host launch cost sits between them."""
    total = 0.0
    for i in range(0, len(launches), CALLS_GRAPHED):
        chunk = launches[i:i + CALLS_GRAPHED]
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for launch in chunk:
                launch()
        graph.replay()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
        del graph
    return total


def replay_shared(name, calls, path):
    """A path's recorded closed-form ("place_closed_form") or score-matrix
    calls, each through the kernel and its plain version (identical
    choices or fits, scores within MAX_ABS_ERR), then the kernel's device
    time over them ("path_ms", ``calls_ms``); for the closed form also the
    forms the path's run launched, by blocks a lane (``Recorder``)."""
    worst, mismatches = 0.0, 0
    for c in calls:
        got = shared_launch(name, c)()
        want = shared_launch(name, c, plain=True)()
        torch.cuda.synchronize()
        mismatches += int((got[0 if name == "place_closed_form" else 1]
                           != want[0 if name == "place_closed_form" else 1]).sum())
        score, ref = got[1 if name == "place_closed_form" else 0], \
            want[1 if name == "place_closed_form" else 0]
        fin = torch.isfinite(ref)
        assert torch.equal(torch.isfinite(score), fin), f"{name} ({path}): infeasible differ"
        if bool(fin.any()):
            worst = max(worst, float((score - ref).abs()[fin].max()))
    assert mismatches == 0, f"{name} ({path}): {mismatches} choices or fits differ from plain"
    assert worst <= MAX_ABS_ERR, f"{name} ({path}): |err| {worst} > {MAX_ABS_ERR}"
    path_ms = calls_ms([shared_launch(name, c) for c in calls])
    out = {"path_ms": path_ms, "calls": len(calls), "max_abs_err": worst,
           "choice_mismatches": mismatches}
    forms = ""
    if name == "place_closed_form":
        # the forms the path's own run launched, by blocks a lane
        launched = collections.Counter()
        for c in calls:
            assert sum(c["launched_forms"].values()) == 1, (path, c["launched_forms"])
            launched.update(c["launched_forms"])
        out["blocks_per_lane"] = dict(sorted(launched.items()))
        out["shapes"] = sorted({
            f"G={c['eligible'].shape[0]} N={c['eligible'].shape[1]} J={c['max_j']} k={c['k']}"
            for c in calls
        })
        forms = f"; forms S={out['blocks_per_lane']} at {out['shapes']}"
    log(
        f"[{name}] {len(calls)} recorded {path} calls replayed: choice_mismatches="
        f"{mismatches} max_abs_err={worst!r}; kernel time over the calls "
        f"path_ms={path_ms!r} (graph replay of the calls; mean "
        f"{path_ms / len(calls)!r} ms){forms}"
    )
    return out


def main_path(dev, n_nodes=10_000, n_jobs=10, count=1000):
    """The slice's two paths. Returns each path's launch counts and the
    recorded kernel calls of each."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.device import score as S
    from nomad_tpu_torch.device import score_triton as ST
    from nomad_tpu_torch.device.flatten import flatten_group_ask
    from nomad_tpu_torch.obs.trace import global_tracer as tracer
    from nomad_tpu_torch.scheduler import Harness
    from nomad_tpu_torch.scheduler.algorithms import score_group

    t0 = time.perf_counter()
    h = Harness(device=dev)
    for _ in range(n_nodes):
        h.store.upsert_node(h.next_index(), mock.node())
    jobs = []
    for _ in range(n_jobs):
        j = mock.job()  # one service group of 500 MHz / 256 MiB tasks
        j.task_groups[0].count = count
        h.store.upsert_job(h.next_index(), j)
        jobs.append(j)
    log(f"[main] set-up {time.perf_counter() - t0:.3f} s ({n_nodes} nodes, {n_jobs} jobs)")

    # path "schedule": each eval runs under a trace; its "kernel.place"
    # spans count the PlacementKernel passes (one closed-form launch each)
    passes = 0
    lat = []
    zero_counters()
    with recording(S, "place_closed_form") as cf_calls:
        t_run = time.perf_counter()
        for j in jobs:
            ev = mock.eval_for(j)
            h.store.upsert_evals(h.next_index(), [ev])
            tracer.begin(ev.id)
            t1 = time.perf_counter()
            with tracer.activate(ev.id):
                h.process(ev)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t1)
            trace = tracer.finish(ev.id)
            passes += sum(sp["name"] == "kernel.place" for sp in trace["spans"])
        sched_s = time.perf_counter() - t_run
    schedule = counters()

    # path "score_group": dry-run annotation of each job's group against
    # the committed state through the registry seam (the system
    # scheduler's score path)
    snap = h.store.snapshot()
    ct = h.device_cache.tensors(snap)
    zero_counters()
    with recording(ST, "score_matrix_triton") as sm_calls:
        for j in jobs:
            tg = j.task_groups[0]
            ga = flatten_group_ask(ct, snap, j, tg, tg.count)
            finals, fits = score_group(ct, ga, tg.count, device=dev)
            assert finals.shape == (ct.padded_n,) and fits.any()
            assert np.isfinite(finals[fits]).all() and np.isneginf(finals[~fits]).all()
    annotate = counters()

    placed = sum(
        1 for j in jobs for a in h.store.allocs_by_job(j.namespace, j.id)
        if not a.terminal_status()
    )
    rejected = sum(len(r.rejected_nodes) for r in h.results)
    over = committed_overcommit(h.store)
    statuses = sorted({e.status for e in h.evals})
    lat_ms = np.array(lat) * 1e3
    log(
        f"[main] placed {placed}/{n_jobs * count} allocs; rejected plan nodes "
        f"{rejected}; over-committed nodes {over}; eval statuses {statuses}"
    )
    log(
        f"[main] {n_jobs} evals in {sched_s:.3f} s: evals/s={n_jobs / sched_s!r} "
        f"allocs/s={placed / sched_s!r} eval p50_ms={float(np.percentile(lat_ms, 50))!r} "
        f"p99_ms={float(np.percentile(lat_ms, 99))!r}"
    )
    log(
        f"[main] launches: schedule path {schedule} ({passes} placement "
        f"passes); score_group path {annotate}"
    )
    assert placed == n_jobs * count, "not every alloc was placed"
    assert rejected == 0, "a plan had rejected nodes"
    assert over == 0, "a node is over-committed in the store"
    assert statuses == ["complete"]
    idle = {name: 0 for name in (
        *COUPLED, *PREEMPT_COUNTS, *PLUGIN, "migrate_plan", "closed_form_topk_merge",
        *MESH_COUPLED, *MESH_PLUGIN,
    )}
    assert schedule == {"place_closed_form": passes, "score_matrix": 0, **idle} and passes > 0
    assert annotate == {"place_closed_form": 0, "score_matrix": n_jobs, **idle}
    assert len(cf_calls) == passes and len(sm_calls) == n_jobs
    return {"schedule": schedule, "score_group": annotate}, cf_calls, sm_calls


# -- phase 5, "spread" path, and phase 6 ---------------------------------------


def spread_fleet(n_nodes=SPREAD_NODES, racks=SPREAD_RACKS):
    """The JAX package's bench.py end_to_end node recipe, as mock nodes."""
    from nomad_tpu_torch import mock

    nodes = []
    for i in range(n_nodes):
        node = mock.node()
        node.datacenter = "dc1"
        node.attributes["platform.rack"] = f"r{i % racks}"
        node.attributes["storage.type"] = "ssd" if i % 4 == 0 else "hdd"
        if i % 3 == 1:
            node.node_resources.cpu = 8000
            node.node_resources.memory_mb = 16384
        node.compute_class()
        nodes.append(node)
    return nodes


def spread_nodes(h, n_nodes=SPREAD_NODES, racks=SPREAD_RACKS):
    for node in spread_fleet(n_nodes, racks):
        h.store.upsert_node(h.next_index(), node)


def spread_jobs(per_job=250, distinct_count=200):
    """(route, job) in processing order: bench.py end_to_end's
    ``make_job(j)`` for j = 0..19 (even rack spread + ssd affinity, every
    third a batch job), then 5 target rack spread jobs (r0–r4 at 20 %
    each) and 5 jobs with a distinct_property rack cap."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs import Affinity, Constraint, Spread, SpreadTarget

    rack = "${attr.platform.rack}"
    jobs = []
    for j in range(20):
        job = mock.batch_job() if j % 3 == 2 else mock.job()
        job.id = f"bench-{j}"
        tg = job.task_groups[0]
        tg.count = per_job
        tg.tasks[0].resources.cpu = int(np.random.default_rng(j).choice([250, 500]))
        job.spreads = [Spread(attribute=rack, weight=50)]
        job.affinities = [
            Affinity(l_target="${attr.storage.type}", r_target="ssd", operand="=", weight=50)
        ]
        jobs.append(("opv", job))
    for j in range(5):
        job = mock.job()
        job.id = f"target-{j}"
        job.task_groups[0].count = per_job
        job.spreads = [
            Spread(attribute=rack, weight=50, targets=[
                SpreadTarget(value=f"r{r}", percent=20) for r in range(5)
            ])
        ]
        jobs.append(("chunked", job))
    for j in range(5):
        job = mock.job()
        job.id = f"distinct-{j}"
        job.task_groups[0].count = distinct_count
        job.task_groups[0].constraints.append(
            Constraint(l_target=rack, r_target=str(DISTINCT_CAP), operand="distinct_property")
        )
        jobs.append(("scan", job))
    return jobs


def spread_path(dev, n_nodes=SPREAD_NODES):
    """The "spread" path: spread and distinct_property jobs through the
    Harness on the card. Returns its launch counts, the recorded calls of
    each coupled kernel and its end-to-end numbers."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.device import score as S
    from nomad_tpu_torch.obs.trace import global_tracer as tracer
    from nomad_tpu_torch.scheduler import Harness

    t0 = time.perf_counter()
    h = Harness(device=dev)
    spread_nodes(h, n_nodes)
    routed = spread_jobs()
    for _, j in routed:
        h.store.upsert_job(h.next_index(), j)
    log(
        f"[spread] set-up {time.perf_counter() - t0:.3f} s ({n_nodes} nodes "
        f"over {SPREAD_RACKS} racks, {len(routed)} jobs)"
    )

    split = {route: 0 for route in ("fast", "chunked", "opv", "scan")}
    lat = []
    zero_counters()
    with contextlib.ExitStack() as stack:
        calls = {name: stack.enter_context(recording(S, name)) for name in COUPLED}
        t_run = time.perf_counter()
        for route, j in routed:
            ev = mock.eval_for(j)
            h.store.upsert_evals(h.next_index(), [ev])
            tracer.begin(ev.id)
            t1 = time.perf_counter()
            with tracer.activate(ev.id):
                h.process(ev)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t1)
            for sp in tracer.finish(ev.id)["spans"]:
                if sp["name"] == "kernel.place":
                    for key in split:
                        split[key] += sp["tags"][key]
        run_s = time.perf_counter() - t_run
    launches = counters()

    want = sum(j.task_groups[0].count for _, j in routed)
    placed = sum(
        1 for _, j in routed for a in h.store.allocs_by_job(j.namespace, j.id)
        if not a.terminal_status()
    )
    rejected = sum(len(r.rejected_nodes) for r in h.results)
    over = committed_overcommit(h.store)
    statuses = sorted({e.status for e in h.evals})
    rack_of = {n.id: n.attributes["platform.rack"] for n in h.store.nodes()}
    worst_rack = 0
    for route, j in routed:
        if route == "scan":
            per_rack = {}
            for a in h.store.allocs_by_job(j.namespace, j.id):
                if not a.terminal_status():
                    r = rack_of[a.node_id]
                    per_rack[r] = per_rack.get(r, 0) + 1
            worst_rack = max(worst_rack, max(per_rack.values()))
    lat_ms = np.array(lat) * 1e3
    log(
        f"[spread] placed {placed}/{want} allocs; rejected plan nodes {rejected}; "
        f"over-committed nodes {over}; eval statuses {statuses}; most allocs of "
        f"one distinct_property job on one rack {worst_rack} (cap {DISTINCT_CAP})"
    )
    log(
        f"[spread] {len(routed)} evals in {run_s:.3f} s: evals/s={len(routed) / run_s!r} "
        f"allocs/s={placed / run_s!r} eval p50_ms={float(np.percentile(lat_ms, 50))!r} "
        f"p99_ms={float(np.percentile(lat_ms, 99))!r}"
    )
    log(f"[spread] launches {launches}; kernel.place split {split}")
    assert placed == want, "not every alloc was placed"
    assert rejected == 0, "a plan had rejected nodes"
    assert over == 0, "a node is over-committed in the store"
    assert statuses == ["complete"]
    assert worst_rack <= DISTINCT_CAP, "a distinct_property cap was exceeded"
    assert launches["place_closed_form"] == 0 and launches["score_matrix"] == 0
    assert all(launches[name] == 0 for name in (*PREEMPT_COUNTS, *PLUGIN))
    assert split["fast"] == 0
    for name, route in COUPLED.items():
        assert launches[name] == split[route], (name, launches[name], split[route])
        assert len(calls[name]) == launches[name]
    assert split["opv"] >= 20 and split["chunked"] >= 5 and split["scan"] >= 5, split
    return h, launches, calls, {
        "evals": len(routed), "placed": placed, "seconds": run_s,
        "p50_ms": float(np.percentile(lat_ms, 50)),
        "p99_ms": float(np.percentile(lat_ms, 99)),
    }


def wide_values_path(h):
    """The "wide_values" path, on the spread path's cluster: one job per
    coupled route with its block keyed on ``${node.unique.id}`` -- an
    even spread (one-per-value), a target spread over five nodes
    (chunked) and a distinct_property cap of one per node (value scan).
    The 10,000 values bucket V to 16,384: the one-per-value kernel's
    lane (~0.7 MB) does not fit in a block's shared memory and runs from
    global scratch; the value scan and the chunked scan run in the form
    their shape picks (each block of a cluster replicates 196 KB of tables
    beside its slice; asserted against ``coupled_cluster_size`` and the
    scratch it asks for). Returns the launch counts and the recorded calls
    of each coupled kernel."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.device import score as S
    from nomad_tpu_torch.obs.trace import global_tracer as tracer
    from nomad_tpu_torch.structs import Constraint, Spread, SpreadTarget

    attr = "${node.unique.id}"
    targets = sorted(n.id for n in h.store.nodes())[:5]
    even, target, distinct = mock.job(), mock.job(), mock.job()
    even.spreads = [Spread(attribute=attr, weight=50)]
    target.spreads = [Spread(attribute=attr, weight=50, targets=[
        SpreadTarget(value=t, percent=20) for t in targets
    ])]
    distinct.task_groups[0].constraints.append(
        Constraint(l_target=attr, r_target="1", operand="distinct_property")
    )
    routed = [("opv", even, 100), ("chunked", target, 60), ("scan", distinct, 40)]
    for route, j, count in routed:
        j.id = f"wide-{route}"
        j.task_groups[0].count = count
        h.store.upsert_job(h.next_index(), j)

    split = {route: 0 for route in ("fast", "chunked", "opv", "scan")}
    first_result = len(h.results)
    zero_counters()
    with contextlib.ExitStack() as stack:
        calls = {name: stack.enter_context(recording(S, name)) for name in COUPLED}
        for _, j, _ in routed:
            ev = mock.eval_for(j)
            h.store.upsert_evals(h.next_index(), [ev])
            tracer.begin(ev.id)
            with tracer.activate(ev.id):
                h.process(ev)
            for sp in tracer.finish(ev.id)["spans"]:
                if sp["name"] == "kernel.place":
                    for key in split:
                        split[key] += sp["tags"][key]
    launches = counters()

    placed = {
        route: [a.node_id for a in h.store.allocs_by_job(j.namespace, j.id)
                if not a.terminal_status()]
        for route, j, _ in routed
    }
    rejected = sum(len(r.rejected_nodes) for r in h.results[first_result:])
    statuses = sorted({e.status for e in h.evals})
    scratch = {
        name: sorted({
            S.coupled_scratch_bytes(
                f"nomad_{name}", c["eligible"].shape[1], *c["block_counts0"].shape[1:]
            )
            for c in calls[name]
        })
        for name in COUPLED
    }
    log(
        f"[wide_values] placed {({r: len(p) for r, p in placed.items()})} of "
        f"{({r: c for r, _, c in routed})}; rejected plan nodes {rejected}; "
        f"launches {launches}; kernel.place split {split}; scratch bytes per "
        f"lane {scratch}"
    )
    assert all(len(placed[r]) == c for r, _, c in routed), placed
    assert len(set(placed["scan"])) == len(placed["scan"]), "a node holds two"
    assert rejected == 0 and statuses == ["complete"]
    assert launches["place_closed_form"] == 0 and launches["score_matrix"] == 0
    assert split["fast"] == 0
    for name, route in COUPLED.items():
        assert launches[name] == split[route] >= 1, (name, launches[name], split)
        assert len(calls[name]) == launches[name]
        assert calls[name][0]["block_counts0"].shape[2] >= SPREAD_NODES
        blocks = {
            S.coupled_cluster_size(
                f"nomad_{name}", c["eligible"].shape[1], *c["block_counts0"].shape[1:]
            )
            for c in calls[name]
        }
        assert (blocks == {1}) == (min(scratch[name]) > 0), (name, blocks, scratch[name])
        assert name != "place_spread_opv" or blocks == {1}, (name, blocks)
    return launches, calls


def coupled_steps(name, c, choices):
    """Steps the kernel ran per lane (it stops after the first step that
    places nothing) and slots per step."""
    if name == "place_value_scan":
        width, total = 1, c["max_steps"]
    elif name == "place_spread_chunked":
        width, total = c["chunk"], c["n_chunks"]
    else:
        width, total = c["k_seg"], c["n_chunks"]
    took = (choices.view(choices.shape[0], total, width) >= 0).any(dim=2)
    with_pick = took.sum(dim=1)
    return torch.clamp(with_pick + 1, max=total), width


def coupled_bound(name, c, choices) -> dict:
    """The bound of one coupled call ``c`` (its arguments by name) from
    the steps this run's data made it take (``choices``): the closed-form
    planes once, then each step's node pass and table update, in f32
    operations over the peak rate, or its inputs read once and its two
    outputs written once over the memory rate."""
    steps, width = coupled_steps(name, c, choices)
    g, n = c["eligible"].shape
    nb, nv = c["block_counts0"].shape[1:]
    passes = 2 if name == "place_spread_opv" else 1
    picks = int((choices >= 0).sum())
    ran = int(steps.sum())
    ops = (
        (g * n + picks) * CLOSED_FORM_OPS_PER_CANDIDATE
        + ran * passes * n * (COUPLED_OPS_PER_NODE + COUPLED_OPS_PER_BLOCK * nb)
        + ran * passes * nb * nv * COUPLED_OPS_PER_TABLE_ENTRY
    )
    in_bytes = nbytes(*[v for v in c.values() if isinstance(v, torch.Tensor)])
    t_bytes = (in_bytes + choices.numel() * 8) / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return {
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "steps": steps, "width": width, "picks": picks,
    }


def check_coupled(name, c, timed, label=" (last call of the path)"):
    """One coupled call through the kernel and its plain version on the
    same inputs: choices identical, scores exact; the kernel timed by
    graph replay, and with ``timed`` the plain version and bound too, and
    the blocks a lane runs on."""
    from nomad_tpu_torch.device import score as S

    kernel = getattr(S, name)
    plain = getattr(S, f"{name}_plain")
    ch, sc = kernel(**c)
    chp, scp = plain(**c)
    torch.cuda.synchronize()
    mismatches = int((ch != chp).sum())
    fin = torch.isfinite(scp)
    inf_agree = bool(torch.equal(torch.isfinite(sc), fin))
    err = float((sc - scp).abs()[fin].max()) if bool(fin.any()) else 0.0
    assert mismatches == 0, f"{name}: {mismatches} choices differ from plain"
    assert inf_agree, f"{name}: untaken slots differ from plain"
    assert err == 0.0, f"{name}: |score error| {err}"
    launch = lambda: kernel(**c)  # noqa: E731
    out = {"max_abs_err": err, "choice_mismatches": mismatches, "ms": graph_ms(launch)}
    if timed:
        bound = coupled_bound(name, c, chp)
        steps, width, picks = bound["steps"], bound["width"], bound["picks"]
        g, n = c["eligible"].shape
        nb, nv = c["block_counts0"].shape[1:]
        run_plain = lambda: plain(**c)  # noqa: E731
        out.update({
            "stream_ms": cuda_ms(launch),
            "plain_ms": graph_ms(run_plain, iters=3),
            "plain_stream_ms": cuda_ms(run_plain, iters=3, warmup=1),
            "bound_ms": bound["bound_ms"],
            "bound_by": bound["bound_by"],
            "steps_per_launch": int(steps.max()),
            "us_per_step": out["ms"] * 1e3 / int(steps.max()),
            "slots_per_step": width,
            "picks": picks,
            "shape": f"G={g} N={n} J={c['max_j']} B={nb} V={nv}{label}",
        })
        out["blocks_per_lane"] = S.coupled_cluster_size(f"nomad_{name}", n, nb, nv)
        log(
            f"[{name}] kernel_ms={out['ms']!r} plain_ms={out['plain_ms']!r} "
            f"(graph replay; back to back on the stream {out['stream_ms']!r} and "
            f"{out['plain_stream_ms']!r}) bound_ms={out['bound_ms']!r} "
            f"({out['bound_by']}); {out['steps_per_launch']} steps x {width} "
            f"slots, {out['us_per_step']!r} us a step, {picks} picks"
            + f", {out['blocks_per_lane']} blocks a lane; {out['shape']}"
        )
    return out


def replay_coupled(name, calls):
    """Every recorded call of one coupled kernel on a path, through the
    kernel and the plain version; each call's kernel timed by graph
    replay ("path_ms" is their sum), the last one in full."""
    worst = {"max_abs_err": 0.0, "choice_mismatches": 0}
    per_call = []
    for i, c in enumerate(calls):
        out = check_coupled(name, c, timed=i == len(calls) - 1)
        worst["max_abs_err"] = max(worst["max_abs_err"], out["max_abs_err"])
        worst["choice_mismatches"] += out["choice_mismatches"]
        per_call.append(out["ms"])
    log(
        f"[{name}] {len(calls)} recorded calls replayed: choice_mismatches="
        f"{worst['choice_mismatches']} max_abs_err={worst['max_abs_err']!r}; "
        f"kernel time over the calls path_ms={sum(per_call)!r} "
        f"(per call {[round(t, 4) for t in per_call]})"
    )
    out.update(worst)
    out["path_ms"] = sum(per_call)
    return out


# (racks, every k-th node without a value, label) of the one-per-value
# phase: V + 1 = 33 (uint8 value ids), 257 (uint16), value-less nodes, and
# V 4,096 (the one-block form, its state in global scratch)
OPV_PHASE_CASES = (
    (32, 0, "V+1=33"),
    (256, 0, "V+1=257"),
    (25, 7, "25 racks, every 7th node without a value"),
    (4096, 0, "V=4096 one-block form, global scratch"),
)


def coupled_inputs(dev, racks, value_less_every=0, route="opv", n_nodes=SPREAD_NODES,
                   count=250, cap_zones=0, ties=False, node_blocks=0, pad=True, n_jobs=1):
    """The call a coupled wrapper gets on the spread path (J 16; the
    one-per-value kernel: k_seg 16, 20 steps; the chunked scan: CHUNK 16
    and the chunk count ``PlacementKernel`` picks; the value scan: the
    steps bucket) for one job of the parity suite's config-3 recipe at
    ``n_nodes`` nodes over ``racks`` rack values (V the next power of
    two), every ``value_less_every``-th node without a value. Further
    shapes: ``cap_zones`` adds a block capping the job at 2 a zone over
    that many zones; ``ties`` gives every node one shape, no load and no
    affinity, so every score ties; ``node_blocks`` replaces the blocks by
    that many keyed on the node, capped at one each (V 16,384 at 10,000
    nodes); ``pad`` False cuts N from the node bucket to ``n_nodes``;
    ``n_jobs`` lanes (jobs of the recipe, each its own ask)."""
    from nomad_tpu_torch.device import parity as PAR
    from nomad_tpu_torch.device import score as S
    from nomad_tpu_torch.device.flatten import ValueBlocks, pad_value_blocks

    ct, asks = PAR.build_config3(n_nodes=n_nodes, n_jobs=n_jobs, count=count, racks=racks)
    pn = ct.padded_n
    rack = asks[0].blocks.value_ids[0]
    if value_less_every:
        for a in asks:
            a.blocks.value_ids[0][:n_nodes:value_less_every] = -1
    if ties:
        ct.capacity[:n_nodes] = ct.capacity[0]
        ct.used[:] = 0.0
        for a in asks:
            a.has_affinities = False
            a.affinity_scores[:] = 0.0
    if cap_zones or node_blocks:
        zone = np.pad((np.arange(n_nodes) % max(cap_zones, 1)).astype(np.int32),
                      (0, pn - n_nodes), constant_values=-1)
        node = np.pad(np.arange(n_nodes, dtype=np.int32), (0, pn - n_nodes), constant_values=-1)
        if node_blocks:
            ids, kinds, nv = [node] * node_blocks, [S.BLOCK_DISTINCT_CAP] * node_blocks, n_nodes
        else:
            ids, kinds = [rack, zone], [S.BLOCK_EVEN_SPREAD, S.BLOCK_DISTINCT_CAP]
            nv = max(racks, cap_zones)
        nb = len(kinds)
        caps = np.full((nb, nv), np.inf, np.float32)
        caps[1 if cap_zones else 0:] = 1.0 if node_blocks else 2.0
        for a in asks:
            a.blocks = ValueBlocks(
                value_ids=np.stack(ids), counts0=np.zeros((nb, nv), np.float32),
                desired=np.full((nb, nv), -1.0, np.float32), caps=caps,
                weights=np.full(nb, 1.0 / nb, np.float32), kinds=np.array(kinds, np.int32),
            )
    n = pn if pad else n_nodes

    def t(x, dtype=None):
        x = np.asarray(x)
        if x.ndim >= 2 and x.shape[-1] == pn:
            x = x[..., :n]
        elif x.shape[:1] == (pn,):
            x = x[:n]
        return torch.from_numpy(np.ascontiguousarray(x, dtype=dtype)).to(dev)

    c = dict(
        capacity=t(ct.capacity, np.float32), used0=t(ct.used, np.float32),
        asks=t(np.stack([a.ask for a in asks]), np.float32),
        eligible=t(np.stack([a.eligible for a in asks]), bool),
        job_counts=t(np.stack([a.job_counts for a in asks]), np.int32),
        desired_totals=t([a.desired_total for a in asks], np.float32),
        penalty_nodes=t(np.stack([a.penalty_nodes for a in asks]), bool),
        affinity_scores=t(np.stack([a.affinity_scores for a in asks]), np.float32),
        has_affinities=t([a.has_affinities for a in asks], bool),
        distinct_hosts=t([a.distinct_hosts for a in asks], bool),
        slot_caps=t(np.stack([
            a.slot_caps if a.slot_caps is not None else np.full(pn, np.inf, np.float32)
            for a in asks
        ]), np.float32),
    )
    c.update({k: t(v) for k, v in pad_value_blocks([a.blocks for a in asks], pn).items()})
    want = count + 16
    if route == "opv":
        k_seg, n_chunks = 16, 20
        c.update(enforce_idx=torch.zeros(len(asks), dtype=torch.int32, device=dev),
                 k_seg=k_seg, n_chunks=n_chunks)
        slots = k_seg * n_chunks
    elif route == "chunked":
        n_chunks = max(4, -(-(-(-want // S.CHUNK)) // 4) * 4)
        c.update(chunk=S.CHUNK, n_chunks=n_chunks)
        slots = S.CHUNK * n_chunks
    else:
        slots = S._steps_bucket(want)
        c.update(max_steps=slots)
    c.update(
        algorithm_spread=False,
        counts=torch.full((len(asks),), min(want, slots), dtype=torch.int32, device=dev),
        max_j=16, jitter=None,
    )
    return c


def opv_kernel_phase(dev):
    """Phase 10: the one-per-value kernel alone at 10,000 nodes (padded to
    16,384) at the widths that pick its forms, each case identical to the
    plain version."""
    from nomad_tpu_torch.device import score as S

    out = {}
    for racks, value_less, label in OPV_PHASE_CASES:
        c = coupled_inputs(dev, racks, value_less)
        r = check_coupled("place_spread_opv", c, timed=True, label=f" (phase 10 {label})")
        n = c["eligible"].shape[1]
        nb, nv = c["block_counts0"].shape[1:]
        scratch = S.coupled_scratch_bytes("nomad_place_spread_opv", n, nb, nv)
        assert (r["blocks_per_lane"] > 1) == (nv + 1 <= 1024), (label, r["blocks_per_lane"])
        assert (scratch > 0) == (nv + 1 > 1024), (label, scratch)
        out[label] = {k: r[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "steps_per_launch", "us_per_step",
            "picks", "blocks_per_lane", "shape",
        )}
        out[label]["scratch_bytes_per_lane"] = scratch
    return out


# (label, coupled_inputs arguments) of phase 11, each case through the
# value scan and the chunked scan: V + 1 = 33 (uint8 value ids) and 257
# (uint16), value-less nodes, B = 2 with a distinct_property cap, a count
# that stops mid-chunk, all-tie scores, N not a multiple of 8, three
# lanes (three clusters), and two blocks of 16,384 values, whose
# replicated tables do not fit in shared memory (the one-block form, its
# state in global scratch)
CLUSTER_PHASE_CASES = (
    ("V+1=33", dict(racks=32)),
    ("V+1=257", dict(racks=256)),
    ("every 7th node without a value", dict(racks=25, value_less_every=7)),
    ("B=2 with a cap of 2 a zone over 40 zones", dict(racks=25, cap_zones=40)),
    ("count 21: stops mid-chunk", dict(racks=25, count=21)),
    ("all-tie scores", dict(racks=32, ties=True)),
    ("N=10,001", dict(racks=25, n_nodes=10_001, pad=False)),
    ("G=3 lanes", dict(racks=25, n_jobs=3)),
    ("B=2 x V=16,384: the one-block form", dict(racks=25, node_blocks=2)),
)


def coupled_cluster_phase(dev):
    """Phase 11: the value scan and the chunked scan alone, on the
    config-3 recipe at 10,000 nodes, in the form each case's shape picks
    (a cluster of 8 blocks a lane, or one block from global scratch),
    identical to the plain version; µs a step and blocks a lane logged."""
    from nomad_tpu_torch.device import score as S

    t0 = time.perf_counter()
    out = {}
    for name, route in (("place_value_scan", "scan"), ("place_spread_chunked", "chunked")):
        out[name] = {}
        for label, kw in CLUSTER_PHASE_CASES:
            c = coupled_inputs(dev, route=route, **kw)
            r = check_coupled(name, c, timed=True, label=f" (phase 11 {label})")
            n = c["eligible"].shape[1]
            nb, nv = c["block_counts0"].shape[1:]
            scratch = S.coupled_scratch_bytes(f"nomad_{name}", n, nb, nv)
            one_block = "node_blocks" in kw
            assert r["blocks_per_lane"] == (1 if one_block else 8), (label, r["blocks_per_lane"])
            assert (scratch > 0) == one_block, (label, scratch)
            assert r["picks"] > 0, label
            out[name][label] = {k: r[k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "steps_per_launch", "us_per_step",
                "picks", "blocks_per_lane", "shape",
            )}
            out[name][label]["scratch_bytes_per_lane"] = scratch
    log(f"[coupled] phase 11: {2 * len(CLUSTER_PHASE_CASES)} cases identical to plain in "
        f"{time.perf_counter() - t0:.3f} s")
    return out


def full_parity(dev) -> dict:
    """The port's parity suite at full size on the card."""
    from nomad_tpu_torch.device.parity import run_parity_suite

    t0 = time.perf_counter()
    res = run_parity_suite(small=False, device=dev)
    log(f"[parity] full-size suite in {time.perf_counter() - t0:.3f} s")
    for name, r in res.items():
        log(
            f"[parity] {name}: placements {r['placements']} score_delta_pct="
            f"{r['score_delta_pct']!r} node_mismatches={r['node_mismatches']} "
            f"failed_device={r['failed_device']} failed_oracle={r['failed_oracle']}"
        )
    for name in ("config3_spread_affinity", "config4_antiaffinity_caps"):
        r = res[name]
        assert abs(r["score_delta_pct"]) <= PARITY_BAR_PCT, (name, r)
        assert r["failed_device"] == 0, (name, r)
    return res


# -- phase 5, "preempt" and "system" paths, and phase 7 ------------------------


def fill_cluster(h, n_nodes=PREEMPT_NODES, seed=23):
    """``n_nodes`` mock nodes (4,000 MHz / 8,192 MiB, 100 / 256 reserved),
    each filled by direct store upserts with 3-6 ballast allocs from the
    ``BALLAST`` jobs, of 600-1,200 MHz (in steps of 100, together over
    2,900 of the 3,900 usable, so under 1,000 MHz stays free) and
    512-2,048 MiB (together at most the 7,936 usable). Returns the
    ballast jobs and the number of allocs."""
    from nomad_tpu_torch import mock

    rng = np.random.default_rng(seed)
    ballast = []
    for prio, batch in BALLAST:
        j = (mock.batch_job if batch else mock.job)(priority=prio)
        j.id = f"ballast-{prio}"
        h.store.upsert_job(h.next_index(), j)
        ballast.append(j)
    allocs = []
    for i in range(n_nodes):
        node = mock.node()
        h.store.upsert_node(h.next_index(), node)
        c = int(rng.integers(3, 7))
        lo, hi = max(30, 6 * c), min(39, 12 * c)  # hundreds of MHz
        cpu = np.full(c, 6)
        for _ in range(int(rng.integers(lo, hi + 1)) - 6 * c):
            cpu[rng.choice(np.flatnonzero(cpu < 12))] += 1
        mem = rng.integers(1, 5, c)
        while mem.sum() * 512 > 7936:
            mem[np.argmax(mem)] -= 1
        for k in range(c):
            j = ballast[int(rng.integers(0, len(ballast)))]
            a = mock.alloc(j, node)
            a.name = f"{j.id}.{a.task_group}[{6 * i + k}]"
            a.client_status = "running"
            a.resources = dataclasses.replace(
                a.resources, cpu=int(cpu[k]) * 100, memory_mb=int(mem[k]) * 512
            )
            allocs.append(a)
    h.store.upsert_allocs(h.next_index(), allocs)
    return ballast, len(allocs)


def preempt_path(dev, n_nodes=PREEMPT_NODES):
    """The "preempt" path: high-priority service and batch jobs on a
    cluster full of lower-priority work, service and batch preemption
    on. Returns the Harness, the launch counts, the recorded calls of the
    two preemption kernels and the rank_preemption_nodes calls."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.device import preempt as P
    from nomad_tpu_torch.scheduler import Harness
    from nomad_tpu_torch.scheduler import preempt_host as PH
    from nomad_tpu_torch.state import SchedulerConfiguration

    t0 = time.perf_counter()
    h = Harness(device=dev)
    h.store.set_scheduler_config(h.next_index(), SchedulerConfiguration(
        preemption_service_enabled=True, preemption_batch_enabled=True,
    ))
    ballast, n_ballast = fill_cluster(h, n_nodes)
    jobs = []
    for prio, batch, n_jobs in PREEMPTORS:
        for i in range(n_jobs):
            j = (mock.batch_job if batch else mock.job)(priority=prio)
            j.id = f"preemptor-{prio}-{i}"
            tg = j.task_groups[0]
            tg.count = PREEMPTOR_COUNT
            tg.tasks[0].resources.cpu, tg.tasks[0].resources.memory_mb = PREEMPTOR_ASK
            h.store.upsert_job(h.next_index(), j)
            jobs.append(j)
    log(
        f"[preempt] set-up {time.perf_counter() - t0:.3f} s ({n_nodes} nodes, "
        f"{n_ballast} ballast allocs of priorities {[j.priority for j in ballast]}, "
        f"{len(jobs)} preempting jobs)"
    )

    lat = []
    host = {}
    first_result = len(h.results)
    zero_counters()
    with contextlib.ExitStack() as stack:
        calls = {name: stack.enter_context(recording(P, name)) for name in PREEMPT}
        ranks = stack.enter_context(recording(P, "rank_preemption_nodes"))
        stack.enter_context(shared_recording("preempt", score_matrix=False))
        stack.enter_context(timing(P, "build_victim_tensors", host))
        stack.enter_context(timing(P, "rank_preemption_nodes", host))
        stack.enter_context(timing(PH, "select_victims", host))
        t_run = time.perf_counter()
        for j in jobs:
            ev = mock.eval_for(j)
            h.store.upsert_evals(h.next_index(), [ev])
            t1 = time.perf_counter()
            h.process(ev)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t1)
        run_s = time.perf_counter() - t_run
    launches = counters()

    prio_of = {j.id: j.priority for j in ballast + jobs}
    want = len(jobs) * PREEMPTOR_COUNT
    placed, victims, bad_victims = 0, 0, 0
    for j in jobs:
        for a in h.store.allocs_by_job(j.namespace, j.id):
            if a.terminal_status():
                continue
            placed += 1
            for vid in a.preempted_allocations:
                victim = h.store.alloc_by_id(vid)
                victims += 1
                ok = (
                    victim.desired_status == "evict"
                    and prio_of[victim.job_id] <= j.priority - 10
                )
                bad_victims += not ok
    results = h.results[first_result:]
    rejected = sum(len(r.rejected_nodes) for r in results)
    victim_jobs = sum(
        len({(a.namespace, a.job_id) for allocs in r.node_preemptions.values() for a in allocs})
        for r in results
    )
    followups = [e for e in h.created_evals if e.triggered_by == "preemption"]
    over = committed_overcommit(h.store)
    statuses = sorted({e.status for e in h.evals})
    lat_ms = np.array(lat) * 1e3
    log(
        f"[preempt] placed {placed}/{want} allocs evicting {victims} (victims at "
        f"or above their preemptor's priority - 10: {bad_victims}); rejected plan "
        f"nodes {rejected}; over-committed nodes {over}; follow-up evals "
        f"{len(followups)} for {victim_jobs} (plan, victim job) pairs; eval "
        f"statuses {statuses}"
    )
    log(
        f"[preempt] {len(jobs)} evals in {run_s:.3f} s: evals/s={len(jobs) / run_s!r} "
        f"allocs/s={placed / run_s!r} eval p50_ms={float(np.percentile(lat_ms, 50))!r} "
        f"p99_ms={float(np.percentile(lat_ms, 99))!r}"
    )
    log(f"[preempt] launches {launches}; rank_preemption_nodes calls {len(ranks)}")
    log(
        f"[preempt] host seconds of the run in rank_preemption_nodes "
        f"{host['rank_preemption_nodes']!r} (building the victim tensors "
        f"{host['build_victim_tensors']!r}), in select_victims "
        f"{host['select_victims']!r}"
    )
    assert placed == want, "not every alloc was placed"
    assert victims >= want and bad_victims == 0, "a victim broke the priority delta"
    assert rejected == 0, "a plan had rejected nodes"
    assert over == 0, "a node is over-committed in the store"
    assert statuses == ["complete"]
    assert len(followups) == victim_jobs > 0, "not one follow-up eval per victim job"
    assert {e.job_id for e in followups} <= {j.id for j in ballast}
    assert len(ranks) >= len(jobs)
    # V 8: one launch a call, the find pass carried in the choice's launch
    chosen = calls["choose_preemption_node"]
    assert launches["choose_preemption_node"] == len(ranks) == len(chosen) == launches[CARRIED]
    assert launches["find_preemption"] == len(calls["find_preemption"]) == 0
    assert launches["place_closed_form"] >= len(jobs) and launches["score_matrix"] == 0
    assert all(launches[name] == 0 for name in (*COUPLED, *PLUGIN))
    assert all(c["victim_prio"].shape[1] == 8 for c in chosen)
    # the find pass each call carried, replayed through find_preemption
    calls["find_preemption"] = chosen
    return h, launches, calls, {
        "evals": len(jobs), "placed": placed, "seconds": run_s,
        "p50_ms": float(np.percentile(lat_ms, 50)),
        "p99_ms": float(np.percentile(lat_ms, 99)), "host_seconds": host,
    }


def system_path(h):
    """The "system" path, on the preempt path's cluster with the default
    scheduler configuration (system preemption on): one system job and
    one sysbatch job at priority ``SYSTEM_PRIORITY``. Returns the launch
    counts and the recorded score-matrix calls."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.device import score_triton as ST
    from nomad_tpu_torch.scheduler import preempt_host as PH
    from nomad_tpu_torch.scheduler import system as SYS
    from nomad_tpu_torch.state import SchedulerConfiguration

    h.store.set_scheduler_config(h.next_index(), SchedulerConfiguration())
    sysjob = mock.system_job(priority=SYSTEM_PRIORITY)
    sysjob.task_groups[0].tasks[0].resources.cpu = 500
    sysjob.task_groups[0].tasks[0].resources.memory_mb = 512
    sysbatch = mock.system_job(priority=SYSTEM_PRIORITY, type="sysbatch")
    sysbatch.id = sysbatch.id.replace("sysjob", "sysbatch")
    jobs = [sysjob, sysbatch]
    for j in jobs:
        h.store.upsert_job(h.next_index(), j)
    prio_of = {j.id: j.priority for j in h.store.jobs()}
    eligible = sum(1 for n in h.store.nodes() if n.ready())

    first_result = len(h.results)
    lat = []
    host = {}
    zero_counters()
    with contextlib.ExitStack() as stack:
        sm_calls = stack.enter_context(recording(ST, "score_matrix_triton"))
        stack.enter_context(timing(SYS, "score_group", host))
        stack.enter_context(timing(PH, "select_victims", host))
        for j in jobs:
            ev = mock.eval_for(j)
            h.store.upsert_evals(h.next_index(), [ev])
            t1 = time.perf_counter()
            h.process(ev)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t1)
    launches = counters()

    rejected = sum(len(r.rejected_nodes) for r in h.results[first_result:])
    report = {}
    for j, ev in zip(jobs, h.evals[-2:]):
        live = [a for a in h.store.allocs_by_job(j.namespace, j.id) if not a.terminal_status()]
        nodes = {a.node_id for a in live}
        failed = sum(m.coalesced_failures + 1 for m in ev.failed_tg_allocs.values())
        victims = [h.store.alloc_by_id(v) for a in live for v in a.preempted_allocations]
        worst = max((prio_of[v.job_id] for v in victims), default=None)
        report[j.type] = (len(live), failed, len(victims), worst)
        assert ev.status == "complete", ev.status
        assert len(nodes) == len(live), f"{j.type}: two allocs on one node"
        assert len(live) + failed == eligible, (j.type, len(live), failed, eligible)
        assert worst is None or worst <= SYSTEM_PRIORITY - 10, (j.type, worst)
        assert all(v.desired_status == "evict" for v in victims)
    assert report["system"][2] > 0, "the system job preempted nothing"
    over = committed_overcommit(h.store)
    log(
        f"[system] {eligible} eligible nodes; per job (placed, failed nodes, "
        f"victims, highest victim priority): {report}; rejected plan nodes "
        f"{rejected}; over-committed nodes {over}; eval ms "
        f"{[round(t * 1e3, 1) for t in lat]}; launches {launches}"
    )
    log(
        f"[system] host seconds of the two evals in score_group "
        f"{host['score_group']!r}, in select_victims {host['select_victims']!r}"
    )
    assert rejected == 0 and over == 0
    # one pass per eval, one task group each: one score-matrix launch each
    assert launches["score_matrix"] == len(jobs) == len(sm_calls)
    assert all(
        launches[name] == 0 for name in ("place_closed_form", *COUPLED, *PREEMPT_COUNTS, *PLUGIN)
    )
    return launches, sm_calls, {"eval_ms": [t * 1e3 for t in lat], "host_seconds": host}


PREEMPT_INPUTS = (
    "capacity", "used", "ask", "eligible", "victim_res", "victim_prio", "victim_mask",
)
PREEMPT_OUTPUTS = {
    "find_preemption": ("feasible", "k", "net", "order"),
    "choose_preemption_node": ("best", "feasible", "k", "net", "order", "score"),
}


def sector_bytes(mask, itemsize):
    """Bytes of the 32-byte sectors that hold the elements of an array of
    ``itemsize``-byte elements where ``mask`` is set: what reading only
    those elements costs."""
    flat = torch.nonzero(mask.reshape(-1)).reshape(-1)
    return int(torch.unique(flat * itemsize // 32).numel()) * 32


def preempt_bound(name, c, outs):
    """The least time for the function on these inputs: the bytes it must
    move over HBM, or its f32 operations on this data's real victims over
    the f32 rate, whichever is larger. It must read the mask, ``eligible``
    and the ask in full, but ``victim_res`` and ``victim_prio`` only where
    the mask is set and ``capacity`` and ``used`` only on rows that hold a
    victim (a row without one is infeasible whatever its usage), each in
    32-byte sectors; it writes every output in full."""
    mask = c["victim_mask"]
    n, _ = mask.shape
    victims = int(mask.sum())
    rows = mask.any(dim=1)
    in_bytes = (
        nbytes(mask, c["eligible"], c["ask"])
        + sector_bytes(mask, 16) + sector_bytes(mask, 4)
        + 2 * sector_bytes(rows, 16)
    )
    t_bytes = (in_bytes + nbytes(*outs)) / HBM_BYTES_PER_S * 1e3
    ops = victims * PREEMPT_OPS_PER_VICTIM
    if name == "choose_preemption_node":
        ops += victims * CHOOSE_OPS_PER_VICTIM + n * CHOOSE_OPS_PER_NODE
    t_ops = ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def check_preempt(name, c, timed, label=""):
    """One call of a preemption kernel through the kernel and its plain
    version on the same inputs: every output identical (scores exact);
    the kernel timed by graph replay, with ``timed`` the plain version
    and the bound too."""
    from nomad_tpu_torch.device import preempt as P

    kernel = getattr(P, name)
    plain = getattr(P, f"{name}_plain")
    args = [c[k] for k in PREEMPT_INPUTS]
    form = launched_find_form(lambda: kernel(*args))
    got = kernel(*args)
    want = plain(*args)
    torch.cuda.synchronize()
    for out, g, w in zip(PREEMPT_OUTPUTS[name], got, want):
        assert torch.equal(g, w.to(g.dtype)), f"{name}{label}: {out} differs from plain"
    err = 0.0
    if name == "choose_preemption_node":
        score, plain_score = got[-1], want[-1]
        fin = torch.isfinite(plain_score)
        err = float((score - plain_score).abs()[fin].max()) if bool(fin.any()) else 0.0
    assert err == 0.0, f"{name}{label}: |score error| {err}"
    launch = lambda: kernel(*args)  # noqa: E731
    out = {"max_abs_err": err, "choice_mismatches": 0, "ms": graph_ms(launch), "form": form}
    if name == "choose_preemption_node":
        # the choice kernel's own launch, on the find pass's outputs
        feasible, net = got[1], got[3]
        out["choice_ms"] = graph_ms(lambda: P.launch_choice(args, feasible, net))
    if timed:
        run_plain = lambda: plain(*args)  # noqa: E731
        bound, by = preempt_bound(name, dict(zip(PREEMPT_INPUTS, args)), got)
        n, v = c["victim_prio"].shape
        out.update({
            "stream_ms": cuda_ms(launch),
            "plain_ms": graph_ms(run_plain),
            "plain_stream_ms": cuda_ms(run_plain),
            "bound_ms": bound,
            "bound_by": by,
            "feasible_nodes": int(got[-4 if name == "find_preemption" else 1].sum()),
            "victims": int(c["victim_mask"].sum()),
            "shape": f"N={n} V={v}{label}",
        })
        choice = (f"; the choice kernel's launch alone {out['choice_ms']!r}"
                  if "choice_ms" in out else "")
        log(
            f"[{name}{label}] form {form!r}; kernel_ms={out['ms']!r} "
            f"plain_ms={out['plain_ms']!r} "
            f"(graph replay; back to back on the stream {out['stream_ms']!r} and "
            f"{out['plain_stream_ms']!r}) bound_ms={out['bound_ms']!r} ({by}); "
            f"{out['victims']} victims, {out['feasible_nodes']} feasible nodes{choice}"
        )
    return out


def launched_find_form(launch) -> str:
    """The find pass's form that one ``launch`` ran, as the wrapper counted
    it at the launch: its own launch's (``find_preemption.forms``), or the
    warp form carried in the choice's launch."""
    from nomad_tpu_torch.device import preempt as P

    forms = dict(P.find_preemption.forms)
    carried = P.find_preemption.carried
    launch()
    ran = [f for f, n in P.find_preemption.forms.items() if n != forms.get(f, 0)]
    if P.find_preemption.carried != carried:
        ran.append("warp, carried in the choice's launch")
    assert len(ran) == 1, ran
    return ran[0]


def replay_preempt(name, calls):
    """Every recorded call of one preemption kernel on the preempt path,
    through the kernel and the plain version; each call's kernel timed
    ("path_ms" is their sum), the last one in full."""
    per_call, choice, forms = [], [], collections.Counter()
    for i, c in enumerate(calls):
        out = check_preempt(name, c, timed=i == len(calls) - 1, label=" (last path call)")
        per_call.append(out["ms"])
        forms[out["form"]] += 1
        if "choice_ms" in out:
            choice.append(out["choice_ms"])
    alone = (f"; the choice kernel's launches alone {sum(choice)!r} (per call "
             f"{[round(t, 4) for t in choice]})" if choice else "")
    log(
        f"[{name}] {len(calls)} recorded calls replayed, all identical to plain; "
        f"find forms launched {dict(forms)}; kernel time over the calls "
        f"path_ms={sum(per_call)!r} (per call {[round(t, 4) for t in per_call]}){alone}"
    )
    out["path_ms"] = sum(per_call)
    out["forms"] = dict(forms)
    if choice:
        out["choice_path_ms"] = sum(choice)
    return out


def preempt_inputs(dev, v, ties=False, n=KERNEL_PHASE_NODES, seed=31):
    """Seeded integer-valued inputs of the preemption kernels: mock-node
    capacities, 0..V victims a node at four batch priorities, a tenth of
    the nodes ineligible; ``ties``: every victim 600 MHz / 1,024 MiB at
    priority 30, so every key of a row ties and index order decides."""
    rng = np.random.default_rng(seed + v)
    cap = np.tile(np.array([3900, 7936, 98304, 1000], np.float32), (n, 1))
    nv = rng.integers(0, v + 1, n)
    mask = np.arange(v)[None, :] < nv[:, None]
    if ties:
        res = np.tile(np.array([600, 1024, 300, 0], np.float32), (n, v, 1))
        prio = np.full((n, v), 30, np.int32)
    else:
        res = np.stack([
            rng.integers(100, 1500, (n, v)), rng.integers(128, 2048, (n, v)),
            rng.integers(0, 4000, (n, v)), rng.integers(0, 100, (n, v)),
        ], -1).astype(np.float32)
        prio = rng.choice([10, 20, 30, 40], (n, v)).astype(np.int32)
    res[~mask] = 0.0
    prio[~mask] = 0
    used = res.sum(axis=1) * (1.0 / max(v / 8, 1)) + np.array([100, 256, 4096, 0])
    arrays = {
        "capacity": cap,
        "used": np.floor(used).astype(np.float32),
        "ask": np.array([1000, 1024, 300, 10], np.float32),
        "eligible": rng.random(n) < 0.9,
        "victim_res": res,
        "victim_prio": prio,
        "victim_mask": mask,
    }
    return {k: torch.from_numpy(np.ascontiguousarray(a)).to(dev) for k, a in arrays.items()}


def exact_sums(c, got):
    """Why the kernels' sums equal the plain version's on integer-valued
    victims: each is exact while every partial sum stays below 2^24. k and
    net depend only on the prefixes up to the first that fits, so the
    largest such prefix (in float64, in the sorted order) must stay below
    2^24; a node whose cpu or memory total reaches 2^24 frees so much that
    its fit clips to 0, so its score is 0 (or -inf when infeasible)
    however the total rounds. Returns (largest prefix at k, nodes whose
    cpu or memory total reaches 2^24)."""
    best, feasible, k, net, order, score = got
    mask = c["victim_mask"]
    res = torch.where(mask[..., None], c["victim_res"], 0.0).double()
    prefix = torch.take_along_dim(res, order.long()[..., None], dim=1).cumsum(dim=1)
    # an eligible node with victims and no fitting prefix depends on all
    # of them; an ineligible one on none
    last = torch.where(k > 0, k.long() - 1, mask.shape[1] - 1)
    at_k = prefix.gather(1, last[:, None, None].expand(-1, 1, 4))[:, 0]
    needed = (k > 0) | (c["eligible"] & mask.any(dim=1))
    largest = float(at_k[needed].max()) if bool(needed.any()) else 0.0
    over = (res.sum(dim=1)[:, :2] >= EXACT_F32_INTEGERS).any(dim=1)
    assert largest < EXACT_F32_INTEGERS, f"a prefix at k reaches {largest}"
    clipped = score[over]
    assert bool(((clipped == 0) | torch.isneginf(clipped)).all()), "a node past 2^24 scores"
    return largest, int(over.sum())


# (label, V, every key tied?, N): the path's width, each form's edges
# (the warp form up to V 32, a warp a row up to 1,024, a cluster up to 16
# blocks of 12,288 positions, the global scratch past it) and tied keys
PREEMPT_PHASE_CASES = (
    ("v8", 8, False, KERNEL_PHASE_NODES),
    ("v8_ties", 8, True, KERNEL_PHASE_NODES),
    ("v32", 32, False, KERNEL_PHASE_NODES),
    ("v33", 33, False, KERNEL_PHASE_NODES),
    ("v64", 64, False, KERNEL_PHASE_NODES),
    ("v256", 256, False, KERNEL_PHASE_NODES),
    ("v256_ties", 256, True, 4096),
    ("v1024", 1024, False, 4096),
    ("v1025", 1025, False, 4096),
    ("v1025_ties", 1025, True, 1024),
    ("v8192", 8192, False, 256),
    ("v32768", 32768, False, 64),
    ("v196608", 196608, False, 8),
    ("v196609", 196609, False, 8),
)


def preempt_kernel_phase(dev):
    """Both preemption kernels alone on ``PREEMPT_PHASE_CASES``: at N
    16,384 V 8 (the preempt path's width: the choice's launch carries the
    find pass), V 32 and 33, 64 and 256, and V 8 and 256 with every key
    tied; V 1,024 and 1,025 on 4,096 nodes (the last warp-a-row width and
    the first cluster one) and 1,025 tied; V 8,192 on 256 nodes and
    32,768 on 64 (about 44 MB of victims each); V 196,608 on 8 nodes (the
    cluster form's capacity) and one past it (the global-scratch form).
    Each case logs the form the wrapper launched, read at the launch."""
    from nomad_tpu_torch.device import preempt as P

    out = {}
    for label, v, ties, n in PREEMPT_PHASE_CASES:
        c = preempt_inputs(dev, v, ties, n=n)
        largest, over = exact_sums(
            c, P.choose_preemption_node_plain(*[c[k] for k in PREEMPT_INPUTS])
        )
        forms = {}
        for name in PREEMPT:
            r = check_preempt(name, c, timed=True, label=f" phase 7 {label}")
            forms[name] = r["form"]
            out.setdefault(name, {})[label] = {
                **{k: r[k] for k in (
                    "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                    "feasible_nodes", "victims", "shape", "choice_ms", "form",
                ) if k in r},
                "largest_prefix_at_k": largest,
                "nodes_past_2_24": over,
            }
        log(f"[preempt phase 7 {label}] forms launched {forms}; largest prefix "
            f"sum at k {largest!r} (< 2^24, exact); {over} nodes whose cpu or "
            f"memory total reaches 2^24, each scored 0 or -inf")
        del c
    out["choose_preemption_node"].update(choice_protocol(dev))
    return out


def graph_nodes(fn) -> int:
    """Nodes of a CUDA graph capturing one call of ``fn``, after a call on
    the capture stream outside the capture (so first-use set-up is not
    captured), read with ``cuGraphGetNodes`` from libcuda."""
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=stream):
        fn()
    libcuda = ctypes.CDLL("libcuda.so.1")
    libcuda.cuGraphGetNodes.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_size_t),
    ]
    count = ctypes.c_size_t(0)
    status = libcuda.cuGraphGetNodes(
        ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(count)
    )
    assert status == 0, f"cuGraphGetNodes returned {status}"
    return count.value


def choice_protocol(dev):
    """The choice kernel's scratch protocol: calls of both forms queued
    back to back on one stream with different inputs and no host sync
    between them, each identical to plain; a graph of one V 8 call (the
    find pass and the choice in one launch), captured after an eager call
    on its stream, replayed between eager calls with other inputs there
    and no sync, each identical to plain; one graph node a choice launch,
    and one a V 8 ``choose_preemption_node`` call (two at V 64: the find
    pass and the choice). The calls launch straight through the kernel
    guard, whose synchronize after each call would put a host sync
    between them."""
    with direct_launches():
        return _choice_protocol(dev)


def _choice_protocol(dev):
    from nomad_tpu_torch.device import preempt as P

    cases = [preempt_inputs(dev, v, n=n, seed=seed) for v, n, seed in (
        (8, KERNEL_PHASE_NODES, 41), (8, 4096, 42), (64, 2048, 43), (8, 1000, 44),
    )]
    args = [[c[k] for k in PREEMPT_INPUTS] for c in cases]
    want = [P.choose_preemption_node_plain(*a) for a in args]
    torch.cuda.synchronize()
    got = [P.choose_preemption_node(*a) for a in args]
    torch.cuda.synchronize()

    def same(g, w, what):
        for out, x, y in zip(PREEMPT_OUTPUTS["choose_preemption_node"], g, w):
            assert torch.equal(x, y.to(x.dtype)), f"{what}: {out} differs"

    for i, g in enumerate(got):
        same(g, want[i], f"back-to-back call {i}")
    # graph replays between eager calls on the capture stream
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        P.choose_preemption_node(*args[0])
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=stream):
        graphed = P.choose_preemption_node(*args[0])
    eager = []
    with torch.cuda.stream(stream):
        for i in (1, 3, 1, 3):
            graph.replay()
            eager.append((i, P.choose_preemption_node(*args[i])))
        graph.replay()
    torch.cuda.synchronize()
    same(graphed, want[0], "graph replay")
    for i, g in eager:
        same(g, want[i], f"eager call {i} between replays")
    a = args[0]
    feasible, net = got[0][1], got[0][3]
    nodes = {
        "choice": graph_nodes(lambda: P.launch_choice(a, feasible, net)),
        "call": graph_nodes(lambda: P.choose_preemption_node(*a)),
        "call_v64": graph_nodes(lambda: P.choose_preemption_node(*args[2])),
    }
    assert nodes == {"choice": 1, "call": 1, "call_v64": 2}, nodes
    log(f"[choose_preemption_node phase 7] {len(args)} calls back to back on one stream "
        f"(V 8 / 8 / 64 / 8, no sync between), and 5 replays of a graph of a V 8 call "
        f"between 4 eager calls on its stream, each identical to plain; graph nodes a "
        f"choice launch {nodes['choice']}, a V 8 call {nodes['call']} (find and choice "
        f"in one launch), a V 64 call {nodes['call_v64']}")
    return {"back_to_back_calls": len(args), "graph_replays_between_eager_calls": 5,
            "graph_nodes": nodes}


# -- phase 5, the plugin paths, and phase 8 -----------------------------------

PLUGIN_NODES = 10_000
DEVICE_CLASSES = ("tpu-v5e", "tpu-v4", "gpu-a100", "cpu")
HETERO_POLICIES = ("maxmin", "makespan", "cost")
HETERO_JOBS_PER_POLICY = 4
HETERO_COUNT = 250
CP_JOBS = 12
CP_GROUPS = 3
CP_COUNT = 40
GANG_JOBS = 16
GANG_GROUPS = 3
GANG_COUNT = 4
GANG_RACK_NODES = 40
GANG_RACKS_PER_POD = 10
# the plugin kernels' wrappers, by module
PLUGIN = {
    "hetero_place": "nomad_tpu_torch.scheduler.hetero",
    "cp_place": "nomad_tpu_torch.device.cp",
    "cp_gang_place": "nomad_tpu_torch.device.cp",
}
# operations of the plugin kernels (the bound counts them on this run's
# data). hetero: per (group, node) cell of the first scan 14 (4 adds, 4
# compares, 2 tests, the key's division and its compare, 2 ands), per
# group and step 20 (the job key's 3-5 ops, its compare, the column
# check's 12 and the key compare); cp: per (group, node) cell of a round
# 16 (4 adds, 4 compares, the distinct test's add and compare, 2 ands,
# the priced utility's 2 subs, a mul and the compare), 24 with the gang
# term (3 table reads' multiply-adds, the conversion, the scale, the
# add), per node and round 10 (4 usage adds, the price update's max,
# mul, add, compare, sub, max)
HETERO_OPS_PER_CELL = 14
HETERO_OPS_PER_GROUP_STEP = 20
CP_OPS_PER_CELL = 16
CP_GANG_OPS_PER_CELL = 24
CP_OPS_PER_NODE_ROUND = 10
PLAIN_TIMED = 1  # plain runs timed (host syncs every step or round)


def plugin_module(name):
    return importlib.import_module(PLUGIN[name])


def mixed_fleet(n_nodes=PLUGIN_NODES, seed=42):
    """``build_mixed_fleet``'s recipe as mock nodes: a device class drawn
    seeded from ``DEVICE_CLASSES``, 4,000 / 8,000 / 16,000 MHz and 8,192
    / 16,384 / 32,768 MiB by class index mod 3."""
    from nomad_tpu_torch import mock

    kind = np.random.default_rng(seed).integers(0, len(DEVICE_CLASSES), n_nodes)
    nodes = []
    for i in range(n_nodes):
        node = mock.node(device_class=DEVICE_CLASSES[kind[i]])
        node.node_resources.cpu = (4000, 8000, 16000)[kind[i] % 3]
        node.node_resources.memory_mb = (8192, 16384, 32768)[kind[i] % 3]
        node.compute_class()
        nodes.append(node)
    return nodes


def mixed_nodes(h, n_nodes=PLUGIN_NODES, seed=42):
    for node in mixed_fleet(n_nodes, seed):
        h.store.upsert_node(h.next_index(), node)


@contextlib.contextmanager
def capturing(cls):
    """Stands in for ``cls.place`` while a path runs and keeps, per pass,
    the node ids its results chose for each (job, group)."""
    real = cls.place
    passes = []

    def place(self, cluster, asks, **kwargs):
        results = real(self, cluster, asks, **kwargs)
        passes.append({
            (a.job_id, a.tg_name): sorted(
                cluster.node_ids[int(r)] for r in res.node_rows if r >= 0
            )
            for a, res in zip(asks, results)
        })
        return results

    cls.place = place
    try:
        yield passes
    finally:
        cls.place = real


@contextlib.contextmanager
def cp_batches():
    """Stands in for ``build_cp_batch`` while a path runs and keeps, per
    call, the score-matrix launches its pass should make: one over every
    ask, two where only some carry a throughput axis."""
    from nomad_tpu_torch.scheduler import cp as SC
    from nomad_tpu_torch.scheduler.algorithms import _normalized_throughputs

    real = SC.build_cp_batch
    launches = []

    def build(cluster, asks, *args, **kwargs):
        launches.append(len({_normalized_throughputs(a) is not None for a in asks}))
        return real(cluster, asks, *args, **kwargs)

    SC.build_cp_batch = build
    try:
        yield launches
    finally:
        SC.build_cp_batch = real


def committed_nodes(h, job):
    """(job id, group) → sorted node ids of the job's live allocs."""
    out = {}
    for a in h.store.allocs_by_job(job.namespace, job.id):
        if not a.terminal_status():
            out.setdefault((job.id, a.task_group), []).append(a.node_id)
    return {k: sorted(v) for k, v in out.items()}


def check_committed(h, jobs, passes, what):
    """Every alloc of the path lies where its kernel pass put it: the plan
    committed the pass's choices, none moved by the repair walk."""
    chosen = {}
    for p in passes:
        chosen.update(p)
    for job in jobs:
        for key, nodes in committed_nodes(h, job).items():
            assert chosen.get(key) == nodes, f"{what}: {key} not where its pass put it"


def run_evals(h, jobs):
    """One eval per job through the Harness; host seconds per eval."""
    from nomad_tpu_torch import mock

    lat = []
    for j in jobs:
        ev = mock.eval_for(j)
        h.store.upsert_evals(h.next_index(), [ev])
        t1 = time.perf_counter()
        h.process(ev)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t1)
    return lat


def path_summary(name, lat, placed, h, first_result, launches):
    results = h.results[first_result:]
    rejected = sum(len(r.rejected_nodes) for r in results)
    over = committed_overcommit(h.store)
    lat_ms = np.array(lat) * 1e3
    run_s = float(np.sum(lat))
    log(
        f"[{name}] {len(lat)} evals in {run_s:.3f} s: evals/s={len(lat) / run_s!r} "
        f"allocs/s={placed / run_s!r} eval p50_ms={float(np.percentile(lat_ms, 50))!r} "
        f"p99_ms={float(np.percentile(lat_ms, 99))!r}; placed {placed}; rejected plan "
        f"nodes {rejected}; over-committed nodes {over}; launches {launches}"
    )
    assert rejected == 0, f"{name}: a plan had rejected nodes"
    assert over == 0, f"{name}: a node is over-committed in the store"
    return {
        "evals": len(lat), "placed": placed, "seconds": run_s,
        "p50_ms": float(np.percentile(lat_ms, 50)),
        "p99_ms": float(np.percentile(lat_ms, 99)),
    }


def live(h, jobs):
    return [
        a for j in jobs for a in h.store.allocs_by_job(j.namespace, j.id)
        if not a.terminal_status()
    ]


def hetero_jobs(seed=43):
    """The hetero path's 12 jobs: ``build_mixed_asks``'s throughput
    profiles, 250 allocs each, cpu and memory drawn from ``seed``."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.scheduler import hetero as H

    rng = np.random.default_rng(seed)
    jobs = []
    for j in range(len(HETERO_POLICIES) * HETERO_JOBS_PER_POLICY):
        job = mock.job()
        job.id = f"hetero-{j}"
        job.throughputs = H.throughput_profile(j, DEVICE_CLASSES)
        tg = job.task_groups[0]
        tg.count = HETERO_COUNT
        tg.tasks[0].resources.cpu = int(rng.choice([500, 1000, 2000]))
        tg.tasks[0].resources.memory_mb = int(rng.choice([512, 1024, 2048]))
        jobs.append(job)
    return jobs


def hetero_path(dev, seed=42):
    """The "hetero" path: 10,000 mixed-class nodes, 12 jobs carrying
    ``build_mixed_asks``'s throughput profiles, 250 allocs each, four
    under each hetero policy in turn. Returns the Harness, the launch
    counts, the recorded calls and the summary."""
    from nomad_tpu_torch.scheduler import Harness
    from nomad_tpu_torch.scheduler import hetero as H
    from nomad_tpu_torch.state import SchedulerConfiguration

    t0 = time.perf_counter()
    h = Harness(device=dev)
    mixed_nodes(h, seed=seed)
    jobs = hetero_jobs(seed + 1)
    for job in jobs:
        h.store.upsert_job(h.next_index(), job)
    log(f"[hetero] set-up {time.perf_counter() - t0:.3f} s ({PLUGIN_NODES} nodes, {len(jobs)} jobs)")

    first_result = len(h.results)
    lat = []
    zero_counters()
    with recording(H, "hetero_place") as calls, capturing(H.HeteroPlacementKernel) as passes:
        for p, policy in enumerate(HETERO_POLICIES):
            h.store.set_scheduler_config(h.next_index(), SchedulerConfiguration(
                scheduler_algorithm=f"hetero-{policy}"
            ))
            lat += run_evals(h, jobs[p * HETERO_JOBS_PER_POLICY:(p + 1) * HETERO_JOBS_PER_POLICY])
    launches = counters()

    allocs = live(h, jobs)
    summary = path_summary("hetero", lat, len(allocs), h, first_result, launches)
    assert len(allocs) == len(jobs) * HETERO_COUNT, "not every alloc was placed"
    check_committed(h, jobs, passes, "hetero")
    # each alloc on a node of a class that maximizes its policy's node key
    by_id = {j.id: (j, HETERO_POLICIES[i // HETERO_JOBS_PER_POLICY]) for i, j in enumerate(jobs)}
    for a in allocs:
        job, policy = by_id[a.job_id]

        def key(c):
            tp = job.throughputs.get(c, 1.0)
            return tp / H.DEVICE_CLASS_COSTS.get(c, 1.0) if policy == "cost" else tp

        best = max(key(c) for c in DEVICE_CLASSES)
        assert key(h.store.node_by_id(a.node_id).device_class) == best, (a.job_id, policy)
    assert launches["hetero_place"] == len(jobs) == len(calls)
    assert launches["place_closed_form"] == launches["score_matrix"] == 0
    assert all(launches[n] == 0 for n in ("cp_place", "cp_gang_place"))
    return h, launches, calls, summary


def cp_jobs(seed=43):
    """The cp path's 12 jobs of 3 groups x 40 allocs at ``build_cp_asks``'s
    asks (the profile asks x 4, priorities 30 / 50 / 80, every 4th job
    distinct_hosts)."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.scheduler import hetero as H
    from nomad_tpu_torch.structs import Constraint, Resources, Task, TaskGroup

    rng = np.random.default_rng(seed)
    jobs = []
    for j in range(CP_JOBS):
        job = mock.job(priority=(30, 50, 80)[j % 3])
        job.id = f"cp-{j}"
        job.throughputs = H.throughput_profile(j, DEVICE_CLASSES)
        cpu = 4 * int(rng.choice([500, 1000, 2000]))
        mem = 4 * int(rng.choice([512, 1024, 2048]))
        job.task_groups = [
            TaskGroup(name=f"tg{k}", count=CP_COUNT, tasks=[
                Task(name=f"tg{k}", driver="exec", resources=Resources(cpu=cpu, memory_mb=mem))
            ])
            for k in range(CP_GROUPS)
        ]
        if j % 4 == 3:
            job.constraints.append(Constraint(operand="distinct_hosts"))
        jobs.append(job)
    return jobs


def cp_path(h, seed=43):
    """The "cp" path, on the hetero path's cluster with cp-pack: 12 jobs of
    3 groups x 40 allocs at ``build_cp_asks``'s asks (the profile asks x 4,
    priorities 30 / 50 / 80, every 4th job distinct_hosts). Returns the
    launch counts, the recorded calls and the summary."""
    from nomad_tpu_torch.device import cp as C
    from nomad_tpu_torch.scheduler import cp as SC
    from nomad_tpu_torch.state import SchedulerConfiguration

    h.store.set_scheduler_config(h.next_index(), SchedulerConfiguration(
        scheduler_algorithm="cp-pack"
    ))
    jobs = cp_jobs(seed)
    for job in jobs:
        h.store.upsert_job(h.next_index(), job)

    first_result = len(h.results)
    zero_counters()
    with recording(C, "cp_place") as calls, capturing(SC.CpPlacementKernel) as passes, \
            shared_recording("cp", closed_form=False), cp_batches() as batches:
        lat = run_evals(h, jobs)
    launches = counters()

    allocs = live(h, jobs)
    summary = path_summary("cp", lat, len(allocs), h, first_result, launches)
    assert len(allocs) == CP_JOBS * CP_GROUPS * CP_COUNT, "not every alloc was placed"
    check_committed(h, jobs, passes, "cp")
    for j in jobs[3::4]:
        nodes = [a.node_id for a in live(h, [j])]
        assert len(nodes) == len(set(nodes)), f"{j.id}: distinct_hosts broken"
    assert launches["cp_place"] == len(jobs) == len(calls)
    # one score-matrix launch a pass (two with mixed throughputs)
    assert len(batches) == len(jobs) and launches["score_matrix"] == sum(batches), batches
    assert launches["place_closed_form"] == launches["hetero_place"] == 0
    return launches, calls, summary


def gang_fleet(n_nodes=PLUGIN_NODES, seed=44):
    """``build_topo_fleet``'s recipe as mock nodes (4,000 MHz / 8,192 MiB):
    contiguous racks of ``GANG_RACK_NODES``, pods of
    ``GANG_RACKS_PER_POD`` racks, ici slices of half a rack, and a seeded
    0-30 % background load as one ballast alloc per node. Returns (the
    ballast job, the nodes, the allocs)."""
    from nomad_tpu_torch import mock

    rng = np.random.default_rng(seed)
    ballast = mock.batch_job(priority=20)
    ballast.id = "gang-ballast"
    nodes, allocs = [], []
    for i in range(n_nodes):
        rack = i // GANG_RACK_NODES
        node = mock.node(topology={
            "rack": f"r{rack:03d}",
            "pod": f"p{rack // GANG_RACKS_PER_POD:02d}",
            "ici": f"i{i // (GANG_RACK_NODES // 2):04d}",
        })
        nodes.append(node)
        load = float(rng.uniform(0.0, 0.3))
        a = mock.alloc(ballast, node)
        a.name = f"{ballast.id}.worker[{i}]"
        a.resources = dataclasses.replace(
            a.resources, cpu=int(4000 * load), memory_mb=int(8192 * load)
        )
        allocs.append(a)
    return ballast, nodes, allocs


def gang_nodes(h, fleet=None):
    """``gang_fleet`` (or copies of ``fleet``, one made before) in the
    Harness ``h``."""
    ballast, nodes, allocs = copy.deepcopy(fleet) if fleet is not None else gang_fleet()
    h.store.upsert_job(h.next_index(), ballast)
    for node in nodes:
        h.store.upsert_node(h.next_index(), node)
    h.store.upsert_allocs(h.next_index(), allocs)


def gang_recipe(h, seed=45, fleet=None):
    """The "gang" path's cluster and jobs on the Harness ``h``: cp-gang,
    ``gang_nodes`` (of ``fleet`` when given), 16 gang jobs of 3 groups x
    4 allocs (even jobs colocate in a rack, odd jobs spread over pods)
    and one gang whose second group fits nowhere. Returns (the jobs, that
    gang)."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.state import SchedulerConfiguration
    from nomad_tpu_torch.structs import Resources, Task, TaskGroup

    h.store.set_scheduler_config(h.next_index(), SchedulerConfiguration(
        scheduler_algorithm="cp-gang"
    ))
    gang_nodes(h, fleet)
    rng = np.random.default_rng(seed)

    def gang_job(name, asks, stanza):
        job = mock.job()
        job.id = name
        job.task_groups = [
            TaskGroup(name=f"tg{k}", count=count, tasks=[
                Task(name=f"tg{k}", driver="exec", resources=Resources(cpu=cpu, memory_mb=mem))
            ])
            for k, (count, cpu, mem) in enumerate(asks)
        ]
        job.gang = {"groups": [tg.name for tg in job.task_groups], **stanza}
        h.store.upsert_job(h.next_index(), job)
        return job

    jobs = []
    for j in range(GANG_JOBS):
        cpu = int(rng.choice([1600, 1800, 2000]))
        mem = int(rng.choice([3200, 3600, 4000]))
        stanza = (
            {"colocate": {"level": "rack", "weight": 2.0}} if j % 2 == 0
            else {"spread": {"level": "pod", "weight": 1.0}}
        )
        jobs.append(gang_job(f"gang-{j}", [(GANG_COUNT, cpu, mem)] * GANG_GROUPS, stanza))
    bad = gang_job("gang-infeasible", [(2, 500, 256), (2, 100_000, 256)],
                   {"colocate": {"level": "rack", "weight": 2.0}})
    return jobs, bad


def gang_path(dev, seed=45):
    """The "gang" path: 10,000 rack/pod/ici nodes with background load,
    cp-gang, 16 gang jobs of 3 groups x 4 allocs (even jobs colocate in a
    rack, odd jobs spread over pods), then one gang whose second group
    fits nowhere and must release whole. Returns the launch counts, the
    recorded calls and the summary."""
    from nomad_tpu_torch.device import cp as C
    from nomad_tpu_torch.scheduler import Harness
    from nomad_tpu_torch.scheduler import cp as SC

    t0 = time.perf_counter()
    h = Harness(device=dev)
    jobs, bad = gang_recipe(h, seed)
    log(f"[gang] set-up {time.perf_counter() - t0:.3f} s ({PLUGIN_NODES} nodes, {len(jobs) + 1} gang jobs)")

    first_result = len(h.results)
    zero_counters()
    with recording(C, "cp_gang_place_ids") as calls, \
            capturing(SC.CpGangPlacementKernel) as passes, \
            shared_recording("gang", closed_form=False), cp_batches() as batches:
        lat = run_evals(h, jobs + [bad])
    launches = counters()

    allocs = live(h, jobs)
    summary = path_summary("gang", lat, len(allocs), h, first_result, launches)
    assert len(allocs) == GANG_JOBS * GANG_GROUPS * GANG_COUNT, "not every alloc was placed"
    check_committed(h, jobs, passes, "gang")
    # the topology term satisfied, as _gang_quality reads it
    for j, job in enumerate(jobs):
        nodes = [h.store.node_by_id(a.node_id) for a in live(h, [job])]
        if j % 2 == 0:
            assert len({n.topology["rack"] for n in nodes}) == 1, (
                f"{job.id}: not in one rack",
                sorted((n.topology["rack"], n.id[:6]) for n in nodes),
            )
        else:
            assert len({n.topology["pod"] for n in nodes}) > 1, f"{job.id}: in one pod"
    # the infeasible gang released whole into one blocked eval
    assert live(h, [bad]) == [], "the infeasible gang left allocs"
    blocked = [e for e in h.created_evals if e.job_id == bad.id and e.status == "blocked"]
    assert len(blocked) == 1, f"{len(blocked)} blocked evals for the released gang"
    failed = [e for e in h.evals if e.job_id == bad.id and e.failed_tg_allocs]
    assert failed and set(failed[-1].failed_tg_allocs) == {"tg0", "tg1"}
    assert all(
        m.rejections.get("gang-infeasible", 0) >= 1
        for m in failed[-1].failed_tg_allocs.values()
    )
    log(f"[gang] {len(jobs)} gangs placed whole with their topology term satisfied; "
        f"gang-infeasible released whole into one blocked eval")
    assert launches["cp_gang_place"] == len(jobs) + 1 == len(calls)
    assert launches["score_matrix"] == sum(batches) == len(batches), batches
    assert launches["place_closed_form"] == launches["cp_place"] == 0
    return launches, calls, summary


# the batch paths' recorded plugin calls, for the "mesh" phase's (h)
MESH_BATCH_CALLS = {}


def batch_paths(dev):
    """The whole-backlog harnesses at full width: ``run_hetero_ab`` (30
    jobs x 100, one pass a policy), ``run_cp_ab`` (100 jobs x 40) and
    ``run_gang_ab`` at its reference size and at 10,000 nodes (100 gang
    jobs x 3 groups), each with the counters zeroed just before it and
    read just after. Returns the launch counts, the recorded calls and
    the reports by path."""
    from nomad_tpu_torch.device import cp as C
    from nomad_tpu_torch.scheduler import cp as SC
    from nomad_tpu_torch.scheduler import hetero as H

    runs = {  # (module, wrapper recorded, its counter, run)
        "hetero_batch": (H, "hetero_place", "hetero_place", lambda: H.run_hetero_ab(
            n_nodes=PLUGIN_NODES, n_jobs=30, count_per_job=100, device=dev)),
        "cp_batch": (C, "cp_place", "cp_place", lambda: SC.run_cp_ab(
            n_nodes=PLUGIN_NODES, n_jobs=100, count_per_job=40, device=dev)),
        "gang_batch": (C, "cp_gang_place_ids", "cp_gang_place", lambda: [
            SC.run_gang_ab(device=dev),
            SC.run_gang_ab(n_nodes=PLUGIN_NODES, n_jobs=100, groups=3, device=dev),
        ]),
    }
    by_path, calls, reports = {}, {}, {}
    for path, (module, fn, name, run) in runs.items():
        t0 = time.perf_counter()
        zero_counters()
        with recording(module, fn) as rec, shared_recording(path), cp_batches() as batches:
            report = run()
        by_path[path] = counters()
        calls[path] = rec
        reports[path] = report
        MESH_BATCH_CALLS[path] = rec
        seconds = time.perf_counter() - t0
        for r in report if isinstance(report, list) else [report]:
            log(f"[{path}] {seconds:.3f} s; report {json.dumps(r, sort_keys=True)}")
            assert r["oracle_mismatches"] == 0, f"{path}: the kernel and plain differ"
            if path == "gang_batch":
                c = r["cp_gang"]
                assert c["gangs_intact"] == c["topology_satisfied"] == r["config"]["gangs"]
        log(f"[{path}] launches {by_path[path]}; build_cp_batch calls {len(batches)}")
        assert by_path[path][name] == len(rec) > 0
        if path != "hetero_batch":
            assert batches and by_path[path]["score_matrix"] == sum(batches), batches
    return by_path, calls, reports


HETERO_INPUTS = ("capacity", "used0", "asks", "counts", "eligible", "tp", "tpmax", "cost")
CP_INPUTS = (
    "capacity", "used0", "asks", "counts", "eligible", "scores", "prio",
    "job_counts", "distinct", "jobgrp",
)
# the gang inputs of cp_gang_place_ids, the form the kernel object passes
GANG_INPUTS = ("gang", "w_rack", "w_pod", "w_ici", "level_ids", "widths")


def plugin_args(fn, c):
    """(positional inputs, steps, max_c[, policy]) of a recorded call of
    the wrapper ``fn``."""
    if fn == "hetero_place":
        return [c[k] for k in HETERO_INPUTS], (c["policy"], c["steps"], c["max_c"])
    inputs = [c[k] for k in CP_INPUTS]
    if fn == "cp_gang_place_ids":
        inputs += [c[k] for k in GANG_INPUTS]
    return inputs + [c["lam0"]], (c["steps"], c["max_c"])


def plugin_bound(name, args, statics, outs):
    """The least time for the function on these inputs: every input the
    launch reads (for the gang kernel, the per-node level ids) read
    once and every output written once over HBM, or the operations of the
    steps (hetero) or rounds (cp) this run's data made it take over the
    f32 rate, whichever is larger. cp counts a (group, node) cell for
    each placement and each lost claim (every such group was active in
    that round), a node for each round run."""
    t_bytes = (nbytes(*args) + nbytes(*outs)) / HBM_BYTES_PER_S * 1e3
    g, n = args[4].shape
    if name == "hetero_place":
        steps = int((outs[0] >= 0).sum())
        ops = g * n * HETERO_OPS_PER_CELL + steps * g * HETERO_OPS_PER_GROUP_STEP
        work = {"steps": steps}
    else:
        rounds = int(outs[3])
        run = min(rounds + 1, statics[0])
        cells = int((outs[0] >= 0).sum())
        per_cell = CP_OPS_PER_CELL
        if name == "cp_gang_place":
            cells += int(outs[5].sum())
            per_cell = CP_GANG_OPS_PER_CELL
        ops = cells * n * per_cell + run * n * CP_OPS_PER_NODE_ROUND
        work = {"rounds": rounds, "rounds_run": run}
    t_ops = ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", work


def plugin_ms(name, args, statics):
    """Device ms of the bare kernel on prepared outputs, without a host
    sync: hetero-greedy from a graph replay, each launch with the copy
    and fills that reset its outputs; the cooperative CP auction by
    ``queued_ms``, its resets outside the windows. ``args`` of the gang
    kernel are in the id form."""
    from nomad_tpu_torch.device import cp as C
    from nomad_tpu_torch.scheduler import hetero as H

    if name == "hetero_place":
        policy, steps, max_c = statics
        choices, choice_tp, used = H.hetero_place(*args, policy, steps, max_c)
        scratch = H.hetero_scratch(*args[5].shape, used.device)

        def launch():
            used.copy_(args[1])
            choices.fill_(-1)
            choice_tp.zero_()
            H._hetero_call(args, policy, steps, max_c, scratch, choices, choice_tp, used)

        return graph_ms(launch)
    common = (*args[:10], args[-1])
    gang_args = tuple(args[10:16]) if name == "cp_gang_place" else None
    call = C._auction_call(name, common, *statics, gang_args)
    return queued_ms(call.reset, call)


def same_outputs(got, want, what):
    for i, (g, w) in enumerate(zip(got, want)):
        same = torch.equal(g.reshape(-1).view(torch.int32), w.reshape(-1).view(torch.int32))
        assert same, f"{what}: output {i} differs from plain"


def check_plugin(name, fn, args, statics, timed, label=""):
    """One call of a plugin kernel through its wrapper ``fn`` and the plain
    version on the same inputs: every output identical, bit for bit; the
    kernel timed (``plugin_ms``), with ``timed`` the plain version and the
    bound too."""
    module = plugin_module(name)
    kernel = getattr(module, fn)
    plain = getattr(module, f"{fn}_plain")
    got = kernel(*args, *statics)
    want = plain(*args, *statics)
    torch.cuda.synchronize()
    same_outputs(got, want, f"{name}{label}")
    out = {"max_abs_err": 0.0, "choice_mismatches": 0, "ms": plugin_ms(name, args, statics)}
    bound, by, work = plugin_bound(name, args, statics, got)
    out.update(work)
    if name == "hetero_place":
        out["us_per_step"] = out["ms"] * 1e3 / max(work["steps"], 1)
    if timed:
        run_plain = lambda: plain(*args, *statics)  # noqa: E731
        g, n = args[4].shape
        out.update({
            "stream_ms": out["ms"],
            "plain_ms": cuda_ms(run_plain, iters=PLAIN_TIMED, warmup=0),
            "bound_ms": bound,
            "bound_by": by,
            "placed": int((got[0] >= 0).sum()),
            "shape": f"G={g} N={n} C={statics[-1]}{label}",
        })
        out["plain_stream_ms"] = out["plain_ms"]
        per_step = f", {out['us_per_step']!r} us a step" if "us_per_step" in out else ""
        log(
            f"[{name}{label}] kernel_ms={out['ms']!r} plain_ms={out['plain_ms']!r} "
            f"bound_ms={bound!r} ({by}); {work}{per_step}, {out['placed']} placed"
        )
    return out


def replay_plugin(name, fn, calls, path):
    """Every recorded call of a plugin kernel's wrapper ``fn`` on a path,
    through the kernel and the plain version; each call's kernel timed
    ("path_ms" is their sum), the last one in full."""
    per_call, work = [], []
    for i, c in enumerate(calls):
        args, statics = plugin_args(fn, c)
        out = check_plugin(name, fn, args, statics, timed=i == len(calls) - 1,
                           label=f" ({path}, last call)")
        per_call.append(out["ms"])
        work.append(out.get("steps", out.get("rounds")))
    per_step = ""
    if name == "hetero_place":
        out["path_us_per_step"] = sum(per_call) * 1e3 / max(sum(work), 1)
        per_step = f" ({out['path_us_per_step']!r} us a step)"
    log(
        f"[{name}] {len(calls)} recorded {path} calls replayed, all identical to "
        f"plain; kernel time over the calls path_ms={sum(per_call)!r}{per_step}; "
        f"steps or rounds per call {work}"
    )
    out["path_ms"] = sum(per_call)
    out["steps_or_rounds_per_launch"] = work
    return out


def plugin_phase_inputs(dev):
    """(name, wrapper, label, args, statics, one-hot args) of phase 8:
    each plugin kernel alone at N 16,384 on seeded inputs at G 1, 30 and
    100, and a tie-heavy case (equal keys, scores and priorities,
    all-infeasible rows, -0.0 in used0). The gang kernel's cases are in
    the id form, with the same inputs in the one-hot form beside them."""
    from nomad_tpu_torch.scheduler import cp as SC
    from nomad_tpu_torch.scheduler import hetero as H

    mixed = H.build_mixed_fleet(PLUGIN_NODES, seed=42)
    topo = SC.build_topo_fleet(
        PLUGIN_NODES, seed=42, racks=PLUGIN_NODES // GANG_RACK_NODES,
        pods=PLUGIN_NODES // GANG_RACK_NODES // GANG_RACKS_PER_POD,
    )

    def tie(args, scores_at=None, prio_at=None):
        args = [a.clone() if isinstance(a, torch.Tensor) else a for a in args]
        used0 = args[1]
        used0[used0 == 0] = -0.0
        args[4][:3] = False  # all-infeasible rows
        if scores_at is not None:
            args[scores_at].zero_()
            args[prio_at].fill_(50.0)
        return args

    cases = []
    for label, g, count, policy in (("g1", 1, 250, 0), ("g30", 30, 100, 0), ("g30", 30, 100, 1),
                                    ("g30", 30, 100, 2), ("g100", 100, 40, 2)):
        b = H.build_hetero_batch(mixed, H.build_mixed_asks(mixed, g, count, seed=7))
        cases.append(("hetero_place", "hetero_place", f"{label} {HETERO_POLICIES[policy]}",
                      list(b.tensors(dev)), (policy, b.steps, b.max_c), None))
    b = H.build_hetero_batch(mixed, H.build_mixed_asks(mixed, 30, 100, seed=7))
    args = tie(b.tensors(dev))
    args[5].fill_(1.0)  # every node key ties: index order decides
    args[6].fill_(1.0)
    cases.append(("hetero_place", "hetero_place", "ties maxmin", args,
                  (0, b.steps, b.max_c), None))
    # negative cpu asks on every 4th group: a commit can make its node
    # fit again behind other rows' heads (the one-warp and the block chain)
    for label, g, count, policy in (("g30", 30, 100, 0), ("g100", 100, 40, 2)):
        b = H.build_hetero_batch(mixed, H.build_mixed_asks(mixed, g, count, seed=7))
        args = list(b.tensors(dev))
        args[2] = args[2].clone()
        args[2][::4, 0] = -500.0
        cases.append(("hetero_place", "hetero_place",
                      f"{label} negative asks {HETERO_POLICIES[policy]}", args,
                      (policy, b.steps, b.max_c), None))
    # G 1,024 (the block chain, its state in shared memory) and G 8,192 on
    # 512 nodes (its state in global memory), one instance a group
    for label, fleet, g in (("g1024", mixed, 1024),
                            ("g8192 on 512 nodes", H.build_mixed_fleet(500, seed=42), 8192)):
        b = H.build_hetero_batch(fleet, H.build_mixed_asks(fleet, g, 1, seed=7))
        cases.append(("hetero_place", "hetero_place", f"{label} makespan",
                      list(b.tensors(dev)), (1, b.steps, b.max_c), None))
    # 1,000 nodes for 30 x 100 allocs: the preferred classes fill mid-pass
    small = H.build_mixed_fleet(1000, seed=42)
    b = H.build_hetero_batch(small, H.build_mixed_asks(small, 30, 100, seed=7))
    cases.append(("hetero_place", "hetero_place", "g30 on 1,000 nodes, classes fill, maxmin",
                  list(b.tensors(dev)), (0, b.steps, b.max_c), None))

    for label, g in (("g1", 1), ("g30", 30), ("g100", 100)):
        asks = SC.build_cp_asks(mixed, g, 40, seed=7)
        lam0 = SC.perturb_prices(mixed.padded_n) if g == 30 else None
        b = SC.build_cp_batch(mixed, asks, lam0=lam0, device=dev)
        cases.append(("cp_place", "cp_place", label + (" lam0 perturbed" if g == 30 else ""),
                      list(b.tensors(dev)), (b.steps, b.max_c), None))
    cases.append(("cp_place", "cp_place", "ties", tie(b.tensors(dev), 5, 6),
                  (b.steps, b.max_c), None))

    for label, jobs, groups in (("g1", 1, 1), ("g30", 10, 3), ("g100", 25, 4)):
        asks = SC.build_gang_asks(topo, jobs, groups, seed=7)
        b = SC.build_cp_batch(topo, asks, device=dev)
        common = b.tensors(dev)
        gi = SC.build_gang_inputs(topo, asks)
        ids = [*common[:10], *gi.id_tensors(dev), common[10]]
        onehot = [*common[:10], *gi.tensors(dev), common[10]]
        cases.append(("cp_gang_place", "cp_gang_place_ids", label, ids,
                      (b.steps, b.max_c), onehot))
    cases.append(("cp_gang_place", "cp_gang_place_ids", "ties", tie(ids, 5, 6),
                  (b.steps, b.max_c), tie(onehot, 5, 6)))
    return cases


BARRIER_PROBE_ITERS = 4096


def barrier_us(library, dev, iters=BARRIER_PROBE_ITERS):
    """Device µs of one grid-wide barrier of ``csrc/<library>.cu``'s
    auction grid: a cooperative launch of nothing but ``iters`` barriers
    less one of a single barrier, over ``iters - 1``, each timed by
    ``queued_ms``."""
    from nomad_tpu_torch import backend

    fn = getattr(backend.cuda_library(library), f"nomad_{library}_barrier_probe")
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    scratch = torch.zeros(2, dtype=torch.int32, device=dev)
    stream = backend.current_stream(dev)

    def probe(k):
        backend.check_launch(fn(k, scratch.data_ptr(), stream), f"{library} barrier probe")

    many = queued_ms(scratch.zero_, lambda: probe(iters), iters=5, warmup=1)
    one = queued_ms(scratch.zero_, lambda: probe(1), iters=5, warmup=1)
    us = (many - one) / (iters - 1) * 1e3
    log(f"[{library} grid barrier] {us!r} us a barrier ({iters} in {many!r} ms, 1 in {one!r} ms)")
    return us


def plugin_kernel_phase(dev):
    """Phase 8: the plugin kernels alone, every case identical to plain;
    the gang cases' one-hot form identical to the id form too."""
    from nomad_tpu_torch.device import cp as C

    out = {}
    for name, fn, label, args, statics, onehot in plugin_phase_inputs(dev):
        r = check_plugin(name, fn, args, statics, timed=True, label=f" phase 8 {label}")
        if onehot is not None:
            got = C.cp_gang_place(*onehot, *statics)
            same_outputs(got, C.cp_gang_place_plain(*onehot, *statics),
                         f"{name} phase 8 {label} one-hot form")
            same_outputs(got, C.cp_gang_place_ids(*args, *statics),
                         f"{name} phase 8 {label} one-hot vs id form")
        out.setdefault(name, {})[label] = {k: r[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "placed", "shape",
            *(("steps", "us_per_step") if name == "hetero_place" else ("rounds", "rounds_run")),
        )}
    out["cp_place"]["grid_barrier_us"] = barrier_us("cp", dev)
    return out


# -- phase 5, the "defrag" path, and phase 9 -----------------------------------

DEFRAG_NODES = 10_000
DEFRAG_ALLOCS = 20_000
DEFRAG_BUDGET = 512
DEFRAG_CYCLES = 4
MIGRATE_TIMED = 3  # kernel calls timed per recorded call (7-16 ms each at full size on an H100)
# operations of the migration auction (the bound counts them on this run's
# data): per (alloc, node) cell of a round 16 (the gain's 3 subs, the fit
# test's 4 adds and 4 compares, the gain > 0 test, the current-node test,
# 2 ands and the argmax compare), per node and round 12 (4 usage adds, the
# price update's max, mul, add, compare, sub and max, the admission scan's
# add and compare)
MIGRATE_OPS_PER_CELL = 16
MIGRATE_OPS_PER_NODE_ROUND = 12
# the least the function needs of each cell: its base gain, once a pass
# ((score - cur_score) - move_cost, 2 subs)
MIGRATE_OPS_PER_CELL_ONCE = 2
MIGRATE_INPUTS = (
    "capacity", "used0", "sizes", "cur", "eligible", "scores", "cur_scores",
    "move_cost", "lam0",
)


def migrate_module():
    return importlib.import_module("nomad_tpu_torch.device.migrate")


def defrag_path(dev):
    """Path "defrag": the port's ``run_defrag_ab`` on the card at 10,000
    nodes x 20,000 allocs, 512 moves a cycle, 4 cycles, then at the
    reference's defaults, with the counters zeroed just before and read
    just after. The reference's recovery gate (half the efficiency gap
    back) is defined at its 48 x 96 default: four 512-move cycles cannot
    recover half of a 20,000-alloc smear, so at full size the other gates
    are asserted and the recovered fraction printed. Returns the launch
    counts, the recorded calls with their labels, and the reports."""
    from nomad_tpu_torch.scheduler import migrate as SM

    t0 = time.perf_counter()
    host = {}  # host seconds of the harness's builds and plain checks
    zero_counters()
    with recording(migrate_module(), "migrate_plan") as calls, \
            timing(SM, "build_defrag_fleet", host), timing(SM, "build_defrag_batch", host), \
            timing(migrate_module(), "migrate_plan_plain", host):
        full = SM.run_defrag_ab(
            n_nodes=DEFRAG_NODES, n_allocs=DEFRAG_ALLOCS, budget=DEFRAG_BUDGET,
            max_cycles=DEFRAG_CYCLES, seed=42, device=dev,
        )
        n_full = len(calls)
        small = SM.run_defrag_ab(device=dev)
    launches = counters()
    seconds = time.perf_counter() - t0
    for r in (full, small):
        log(f"[defrag] report {json.dumps(r, sort_keys=True)}")
        assert r["oracle_mismatches"] == 0, "defrag: the kernel and plain differ"
        assert r["capacity_violations"] == 0, "defrag: a node over capacity"
        assert r["budget_exceeded_cycles"] == 0, "defrag: a cycle over budget"
        assert r["after"]["packing_efficiency"] > r["before"]["packing_efficiency"]
    assert small["ok"], "defrag: the reference's gate failed at its default size"
    log(
        f"[defrag] {DEFRAG_NODES} nodes x {DEFRAG_ALLOCS} allocs, budget "
        f"{DEFRAG_BUDGET}: {full['cycles']} cycles, {full['moves_total']} moves, "
        f"efficiency {full['before']['packing_efficiency']!r} -> "
        f"{full['after']['packing_efficiency']!r}, recovered_fraction="
        f"{full['recovered_fraction']!r}; {seconds:.3f} s with the defaults' run, of "
        f"it host seconds {host}; launches {launches}"
    )
    assert full["cycles"] > 0
    assert launches["migrate_plan"] == len(calls) == n_full + 2 + small["cycles"] + (
        small["cycles"] < small["config"]["max_cycles"]
    )
    labels = [f"full check seed {42 + i}" for i in range(2)]
    labels += [f"full cycle {i + 1}" for i in range(n_full - 2)]
    labels += [f"defaults call {i + 1}" for i in range(len(calls) - n_full)]
    return launches, list(zip(labels, calls)), {"full": full, "defaults": small}


def migrate_bound(inputs, budget, steps, outs):
    """The least time for the pass on these inputs: every input read once
    and every output written once over HBM, or the least operations over
    the f32 rate (each cell's base gain once, each node's update every
    round run), whichever is larger. Beside it, the reference's
    dense work over the f32 rate: the operations of pricing every cell of
    the grid every round this run's data made it take (a round counts a
    cell for every alloc still in place at its end, a lower bound of the
    rows it priced, and every node). That is how the reference computes
    the function, not the least work the function needs: the kernel's
    early exit prices far fewer cells and may run under it."""
    t_bytes = (nbytes(*inputs) + nbytes(*outs)) / HBM_BYTES_PER_S * 1e3
    a, n = inputs[5].shape
    moves, rounds = int(outs[3]), int(outs[4])
    # the loop stops after a round without a claimant (not counted in
    # rounds) unless the budget or ``steps`` ended it
    run = min(steps, rounds + 1) if moves < budget else max(rounds, 1)
    least = a * n * MIGRATE_OPS_PER_CELL_ONCE + run * n * MIGRATE_OPS_PER_NODE_ROUND
    t_ops = least / F32_OPS_PER_S * 1e3
    dense = run * ((a - moves) * n * MIGRATE_OPS_PER_CELL + n * MIGRATE_OPS_PER_NODE_ROUND)
    work = {"rounds": rounds, "rounds_run": run, "moves": moves,
            "reference_dense_ms": dense / F32_OPS_PER_S * 1e3}
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations", work


def check_migrate(inputs, budget, steps, timed, label):
    """One pass through ``migrate_plan`` and the plain version on the same
    inputs: every output identical, bit for bit; the kernel timed by
    ``queued_ms`` over ``MIGRATE_TIMED`` launches, with ``timed`` the
    plain version and the bound too."""
    M = migrate_module()
    got = M.migrate_plan(*inputs[:8], budget, inputs[8], steps)
    want = M.migrate_plan_plain(*inputs[:8], budget, inputs[8], steps)
    torch.cuda.synchronize()
    same_outputs(got, want, f"migrate_plan {label}")
    call = M._migrate_call(inputs, budget, steps)
    ms = queued_ms(call.reset, call, iters=MIGRATE_TIMED, warmup=1)
    bound, by, work = migrate_bound(inputs, budget, steps, got)
    out = {"max_abs_err": 0.0, "choice_mismatches": 0, "ms": ms, **work}
    a, n = inputs[5].shape
    shape = f"A={a} N={n} budget={budget} steps={steps}"
    if timed:
        plain = lambda: M.migrate_plan_plain(*inputs[:8], budget, inputs[8], steps)  # noqa: E731
        out.update({
            "stream_ms": ms,
            "plain_ms": cuda_ms(plain, iters=PLAIN_TIMED, warmup=0),
            "bound_ms": bound,
            "bound_by": by,
            "shape": shape,
        })
        out["plain_stream_ms"] = out["plain_ms"]
        log(
            f"[migrate_plan {label}] {shape}: kernel_ms={ms!r} "
            f"plain_ms={out['plain_ms']!r} bound_ms={bound!r} ({by}; the reference's "
            f"dense work {work['reference_dense_ms']!r} ms); {work}"
        )
    else:
        log(f"[migrate_plan {label}] {shape}: kernel_ms={ms!r}; {work}")
    return out


def replay_migrate(calls, timed_label="full cycle"):
    """Every recorded call of a path through the kernel and the plain
    version, each kernel timed ("path_ms" is their sum); the last call
    whose label starts with ``timed_label`` timed in full."""
    t0 = time.perf_counter()
    last_full = max(i for i, (label, _) in enumerate(calls) if label.startswith(timed_label))
    per_call, rounds, main = [], [], None
    for i, (label, c) in enumerate(calls):
        inputs = [c[k] for k in MIGRATE_INPUTS]
        out = check_migrate(inputs, c["budget"], c["steps"], i == last_full, label)
        per_call.append(out["ms"])
        rounds.append(out["rounds"])
        if i == last_full:
            main = out
    log(
        f"[migrate_plan] {len(calls)} recorded {timed_label} calls replayed, all identical "
        f"to plain; kernel time over the calls path_ms={sum(per_call)!r}; rounds "
        f"per call {rounds}; replay {time.perf_counter() - t0:.3f} s"
    )
    main["path_ms"] = sum(per_call)
    main["rounds_per_launch"] = rounds
    return main


def migrate_inputs(dev, seed, n, a, ties=False, perturbed=False, prices=None):
    """Seeded general inputs on the card: contended integer resources,
    scores on a 1/16 grid that differ by row, 80 % eligibility; with
    ``ties`` every score and stay value equal, three all-infeasible rows
    and -0.0 in used0 and lam0; with ``perturbed`` lam0 on a 1/8 grid.
    ``prices`` sets lam0 for the kernel's early exit: "positive" (every
    price 1/8 to 1, so the least price is above 0), "negative" (-1/2 to
    1/2 on a 1/8 grid), "boundary" (0 or 1/16 under the 1/16 score grid,
    so that a later entry's bound equals the best gain exactly and the
    node index decides), "priced_out" (scores falling with the node
    index, the same on every row, and the first 2,048 nodes priced out:
    every row's best node lies past a run of priced-out nodes longer than
    its list)."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def pick(values, size):
        v = torch.tensor(values, dtype=torch.float32, device=dev)
        return v[torch.randint(0, len(values), (size,), generator=g, device=dev)]

    capacity = torch.tensor([4000.0, 8192.0, 102400.0, 1000.0], device=dev).repeat(n, 1)
    frac = torch.rand((n, 1), generator=g, device=dev) * 0.6
    used0 = torch.floor(capacity * frac)
    used0[:, 3] = 0.0
    sizes = torch.zeros((a, 4), dtype=torch.float32, device=dev)
    sizes[:, 0] = pick([200.0, 400.0, 800.0, 1600.0], a)
    sizes[:, 1] = pick([512.0, 1024.0, 2048.0], a)
    sizes[:, 2] = 300.0
    cur = torch.randint(0, n, (a,), generator=g, device=dev, dtype=torch.int32)
    eligible = torch.rand((a, n), generator=g, device=dev) < 0.8
    scores = torch.round(torch.rand((a, n), generator=g, device=dev) * 16) / 16
    cur_scores = torch.round(torch.rand(a, generator=g, device=dev) * 8) / 16
    move_cost = torch.full((a,), 0.0625, dtype=torch.float32, device=dev)
    lam0 = torch.zeros(n, dtype=torch.float32, device=dev)
    if ties:
        scores.fill_(0.75)
        cur_scores.fill_(0.125)
        eligible.fill_(True)
        eligible[:3] = False
        used0[used0 == 0] = -0.0
        used0[::5] = -0.0
        lam0[::2] = -0.0
    if perturbed:
        lam0 = torch.randint(0, 4, (n,), generator=g, device=dev).to(torch.float32) * 0.125
    steps_of = {"positive": (1, 9, 0.125), "negative": (-4, 5, 0.125), "boundary": (0, 2, 0.0625)}
    if prices in steps_of:
        lo, hi, step = steps_of[prices]
        lam0 = torch.randint(lo, hi, (n,), generator=g, device=dev).to(torch.float32) * step
    elif prices == "priced_out":
        falling = torch.round((1.0 - torch.arange(n, device=dev) / n) * 16) / 16
        scores = falling[None, :].expand(a, n).contiguous()
        lam0[:2048] = 4.0
    return [capacity, used0, sizes, cur, eligible, scores, cur_scores, move_cost, lam0]


def migrate_kernel_phase(dev):
    """Phase 9: the migration-auction kernel alone at N 16,384, every case
    identical to plain."""
    from nomad_tpu_torch.scheduler.migrate import _steps_for

    t0 = time.perf_counter()
    n = KERNEL_PHASE_NODES
    wide = migrate_inputs(dev, 11, n, 20_000)
    mid = migrate_inputs(dev, 12, n, 2_000)
    cases = [
        ("a20000 budget 512", wide, 512, _steps_for(20_000)),
        ("a20000 steps 2", wide, 20_000, 2),
        ("a2000 budget 0", mid, 0, _steps_for(2_000)),
        ("a2000 budget 1", mid, 1, _steps_for(2_000)),
        ("a2000 budget A", mid, 2_000, _steps_for(2_000)),
        ("a2000 lam0 perturbed", migrate_inputs(dev, 13, n, 2_000, perturbed=True),
         2_000, _steps_for(2_000)),
        ("ties a2000 budget 64", migrate_inputs(dev, 14, n, 2_000, ties=True), 64,
         _steps_for(2_000)),
        ("ties a256 budget A", migrate_inputs(dev, 15, n, 256, ties=True), 256,
         _steps_for(256)),
        ("a2000 lam0 positive", migrate_inputs(dev, 16, n, 2_000, prices="positive"),
         2_000, _steps_for(2_000)),
        ("a2000 lam0 negative", migrate_inputs(dev, 17, n, 2_000, prices="negative"),
         2_000, _steps_for(2_000)),
        ("a2000 priced-out run", migrate_inputs(dev, 18, n, 2_000, prices="priced_out"),
         2_000, _steps_for(2_000)),
        ("a2000 ties at the stop boundary",
         migrate_inputs(dev, 19, n, 2_000, prices="boundary"), 2_000, _steps_for(2_000)),
    ]
    out = {}
    for label, inputs, budget, steps in cases:
        r = check_migrate(inputs, budget, steps, timed=True, label=f"phase 9 {label}")
        out[label] = {k: r[k] for k in (
            "ms", "plain_ms", "bound_ms", "bound_by", "reference_dense_ms", "rounds",
            "rounds_run", "moves", "shape",
        )}
    assert out["a20000 steps 2"]["rounds"] == 2, "phase 9: steps did not cut the pass"
    out["grid_barrier_us"] = barrier_us("migrate", dev)
    log(f"[migrate_plan] phase 9: {len(cases)} cases identical to plain in "
        f"{time.perf_counter() - t0:.3f} s")
    return out


# -- phase 5, what the server stands on ----------------------------------------

SERVER_NODES = 10_000
SERVER_JOBS = 10
SERVER_COUNT = 1000
PLAN_COUNT = 1000
RESTORE_COUNT = 20
RESTORE_ASK = (100, 64)  # MHz, MiB: fits beside the preempt path's ballast
UPLOAD_REPEATS = 20  # steady-state used uploads timed a kind


def schedule_fleet(n_nodes=SERVER_NODES, n_jobs=SERVER_JOBS, count=SERVER_COUNT):
    """The schedule path's recipe (mock nodes, service jobs of 500 MHz /
    256 MiB tasks), built once so that every harness of these paths holds
    the same ids."""
    from nomad_tpu_torch import mock

    nodes = [mock.node() for _ in range(n_nodes)]
    jobs = []
    for i in range(n_jobs):
        j = mock.job()
        j.id = f"sched-{i}"
        j.task_groups[0].count = count
        jobs.append(j)
    return nodes, jobs


def fleet_harness(dev, nodes, jobs, mesh=None):
    """A Harness on ``dev`` (its views and passes laid out over ``mesh``
    when one is given) holding copies of ``nodes`` and ``jobs``."""
    from nomad_tpu_torch.scheduler import Harness

    h = Harness(device=dev, mesh=mesh)
    for n in nodes:
        h.store.upsert_node(h.next_index(), copy.deepcopy(n))
    for j in jobs:
        h.store.upsert_job(h.next_index(), copy.deepcopy(j))
    return h


def eval_of(h, job, tag):
    from nomad_tpu_torch import mock

    ev = mock.eval_for(h.store.job_by_id(job.namespace, job.id), id=f"{tag}-{job.id}")
    h.store.upsert_evals(h.next_index(), [ev])
    return ev


@contextlib.contextmanager
def incremental_seam(on: bool):
    """``NOMAD_TPU_INCREMENTAL`` set on or off for a block, then restored."""
    from nomad_tpu_torch import backend

    prev = os.environ.get("NOMAD_TPU_INCREMENTAL")
    os.environ["NOMAD_TPU_INCREMENTAL"] = "on" if on else "off"
    backend.reset_incremental()
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop("NOMAD_TPU_INCREMENTAL", None)
        else:
            os.environ["NOMAD_TPU_INCREMENTAL"] = prev
        backend.reset_incremental()


@contextlib.contextmanager
def timed_uploads():
    """Stands in for the ``used_device`` seam while a block runs and times
    each call: host ms (the call to its return, the cache's bytewise diff
    included, then a sync) and ms between CUDA events on the current
    stream around it (which holds the host's work too: the stream waits
    on it). Each record says what the call did, from the cache's
    counters: "scratch" (seam off: a whole upload), "rebuild", "patch"
    (with its dirty rows) or "reuse". The seam is replaced in every port
    module that bound it by name (the hetero and CP kernel objects) as
    well as in ``device/score.py``."""
    import nomad_tpu_torch.scheduler.cp  # noqa: F401  (bind before the swap)
    import nomad_tpu_torch.scheduler.hetero  # noqa: F401
    from nomad_tpu_torch.device import score as S

    real = S.used_device
    holders = [
        m for name, m in sorted(sys.modules.items())
        if name.startswith("nomad_tpu_torch") and getattr(m, "used_device", None) is real
    ]
    records = []

    def timed(cluster, used0, device, cfg=None, **kw):
        cache = getattr(cluster, "score_cache", None)
        before = cache.device_counters() if cache is not None else None
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        t0 = time.perf_counter()
        out = real(cluster, used0, device, cfg, **kw)
        end.record()
        torch.cuda.synchronize()
        rec = {
            "host_ms": (time.perf_counter() - t0) * 1e3,
            "device_ms": start.elapsed_time(end),
            "bytes": int(np.asarray(used0).nbytes),
            "rows": int(np.asarray(used0).shape[0]),
        }
        if cache is None:
            rec.update(kind="scratch", dirty_rows=rec["rows"])
        else:
            after = cache.device_counters()
            d = {k: after[k] - before[k] for k in after if isinstance(after[k], int)}
            kind = ("rebuild" if d["score_full_rebuilds"] else
                    "patch" if d["score_patch_uploads"] else "reuse")
            rec.update(kind=kind, dirty_rows=d["score_rows_rescored"])
        records.append(rec)
        return out

    for m in holders:
        m.used_device = timed
    try:
        yield records
    finally:
        for m in holders:
            m.used_device = real


@contextlib.contextmanager
def placement_results(cls):
    """Stands in for ``cls.place`` (a placement kernel object) and keeps,
    per pass, each lane's node rows and scores (uint32 views) as the
    kernel gave them, before the repair walk."""
    real = cls.place
    passes = []

    def place(self, cluster, asks, **kwargs):
        results = real(self, cluster, asks, **kwargs)
        passes.append([
            (np.asarray(r.node_rows).copy(),
             np.asarray(r.scores, np.float32).view(np.uint32).copy())
            for r in results
        ])
        return results

    cls.place = place
    try:
        yield passes
    finally:
        cls.place = real


def upload_summary(records) -> dict:
    """The timed ``used`` uploads by what each did: calls, dirty rows, and
    host and event ms of the first call and the median."""
    out = {}
    for kind in ("scratch", "rebuild", "patch", "reuse"):
        recs = [r for r in records if r["kind"] == kind]
        if not recs:
            continue
        out[kind] = {
            "calls": len(recs),
            "dirty_rows_mean": float(np.mean([r["dirty_rows"] for r in recs])),
            "bytes": recs[0]["bytes"],
        }
        for key in ("host_ms", "device_ms"):
            out[kind][f"{key}_first"] = recs[0][key]
            out[kind][f"{key}_median"] = float(np.median([r[key] for r in recs]))
    return out


def expected_eval_counters(dirty, rows, uploads) -> dict:
    """The score-state counters of evals with a commit after each, as
    ``tests/test_torch_incremental.py`` predicts them for one-pass evals:
    the first upload rebuilds every row, the first upload of each later
    eval patches the rows the previous eval placed on (``dirty``: those
    row counts, in eval order; none after an eval that placed nothing),
    and every other upload of an eval (a CP pass's second) is served as
    is. ``rows``: the uploaded array's rows; ``uploads``: the seam's
    calls over the evals."""
    patches = sum(1 for d in dirty if d)
    return {
        "score_rows_rescored": rows + sum(dirty),
        "score_rows_reused": (uploads - 1) * rows - sum(dirty),
        "score_patch_uploads": patches,
        "score_full_rebuilds": 1,
        "score_swaps": patches + 1,
        "score_gen": patches + 1,
    }


def seam_run(dev, nodes, jobs, on, algorithm=None, kernel_cls=None):
    """One arm of the "incremental" path: an eval a job of ``jobs`` on a
    fresh harness holding copies of ``nodes`` (under ``algorithm`` when
    given), the seam on or off; on, a commit and ``verify_score_view() ==
    []`` after each eval. Returns the harness, the kernel object's node
    rows and uint32 scores a pass (``kernel_cls``, the closed form's
    ``PlacementKernel`` by default), where each job's allocs landed, the
    cache's counters, the timed ``used`` uploads and the summary."""
    from nomad_tpu_torch.device import score as S
    from nomad_tpu_torch.state import SchedulerConfiguration

    with incremental_seam(on), timed_uploads() as uploads, \
            placement_results(kernel_cls or S.PlacementKernel) as passes:
        h = fleet_harness(dev, nodes, jobs)
        if algorithm is not None:
            h.store.set_scheduler_config(h.next_index(), SchedulerConfiguration(
                scheduler_algorithm=algorithm
            ))
        cache = h.device_cache
        lat = []
        for j in jobs:
            ev = eval_of(h, j, "incr")
            t1 = time.perf_counter()
            h.process(ev)
            torch.cuda.synchronize()
            lat.append(time.perf_counter() - t1)
            if on:
                cache.score_commit()
                assert cache.verify_score_view() == [], "a generation diverged"
    placed = {
        j.id: sorted((a.name, a.node_id) for a in h.store.allocs_by_job(j.namespace, j.id))
        for j in jobs
    }
    name = f"incremental {algorithm or 'binpack'} {'on' if on else 'off'}"
    return {
        "h": h, "on": on, "passes": passes, "placed": placed,
        "counters": cache.device_counters(), "uploads": list(uploads),
        "summary": path_summary(name, lat, sum(map(len, placed.values())), h, 0, "-"),
    }


def check_seam_arms(runs, jobs, what) -> dict:
    """Every arm gave the first arm's node rows and uint32 scores a pass
    and placed every alloc where it did; each off arm touched no score
    state, and each on arm counted what ``expected_eval_counters``
    predicts from where the allocs landed. Returns the on arms'
    counters (all equal)."""
    base = runs[0]
    for run in runs:
        assert len(run["passes"]) == len(base["passes"]) >= len(jobs), what
        for p, (a, b) in enumerate(zip(base["passes"], run["passes"])):
            assert len(a) == len(b), f"{what}: pass {p} lanes differ"
            for (ra, sa), (rb, sb) in zip(a, b):
                assert np.array_equal(ra, rb) and np.array_equal(sa, sb), \
                    f"{what}: pass {p} differs with the seam on and off"
        assert run["placed"] == base["placed"], f"{what}: the seam changed where allocs landed"
    got = None
    for run in runs:
        if not run["on"]:
            assert run["counters"]["score_gen"] == 0, what
            continue
        rows = {r["rows"] for r in run["uploads"]}
        assert len(rows) == 1, (what, rows)
        dirty = [len({node for _, node in run["placed"][j.id]}) for j in jobs[:-1]]
        want = expected_eval_counters(dirty, rows.pop(), len(run["uploads"]))
        got = {k: run["counters"][k] for k in want}
        assert got == want, (what, got, want)
    return got


# the spread path's jobs the "incremental" path's spread arm runs: four
# one-per-value, two chunked and two value-scan jobs
SEAM_SPREAD_JOBS = (0, 1, 2, 3, 20, 21, 25, 26)
# the schedule arms' seam order: off, on, on, off, so that neither seam
# always runs first on its fresh harness
SEAM_ORDER = (False, True, True, False)


def seam_upload_tail(dev, h, last_job, on):
    """After an arm's evals: one more upload on its committed state (the
    last eval's rows dirty) and, on, one with no dirty row; then
    ``UPLOAD_REPEATS`` uploads of each kind on that state, its ``used``
    and a copy with the last eval's rows moved in turn (off: whole
    uploads; on: patches of those rows, a commit after each, then passes
    with nothing dirty)."""
    from nomad_tpu_torch.device import score as S

    cache = h.device_cache
    with incremental_seam(on), timed_uploads() as uploads:
        ct = cache.tensors(h.store.snapshot())
        S.used_device(ct, ct.used, dev)
        if on:
            cache.score_commit()
            assert cache.verify_score_view() == []
            S.used_device(ct, ct.used, dev)
            assert cache.verify_score_view() == []
        post = len(uploads)
        moved = ct.used.copy()
        last = {a.node_id for a in h.store.allocs_by_job(last_job.namespace, last_job.id)}
        moved[[ct.node_row[n] for n in last], 0] += 1.0
        variants = (moved, ct.used)
        for i in range(UPLOAD_REPEATS):
            S.used_device(ct, variants[i % 2], dev)
            if on:
                cache.score_commit()
        if on:
            for _ in range(UPLOAD_REPEATS):
                S.used_device(ct, variants[(UPLOAD_REPEATS - 1) % 2], dev)
            assert cache.verify_score_view() == []
    return upload_summary(uploads[:post]), upload_summary(uploads[post:])


def incremental_path(dev, nodes, jobs):
    """The "incremental" path: the schedule path's evals on four fresh
    harnesses, the seam off, on, on and off (``SEAM_ORDER``), every
    ``used`` upload timed; then each arm's ``seam_upload_tail``. Every
    arm gives identical node rows and uint32 scores a pass and places the
    same allocs, and each on arm's counters are what the CPU test
    predicts. Returns the launch counts and the summary."""
    zero_counters()
    runs = []
    with shared_recording("incremental", score_matrix=False):
        for on in SEAM_ORDER:
            run = seam_run(dev, nodes, jobs, on)
            run["post"], run["steady"] = seam_upload_tail(dev, run["h"], jobs[-1], on)
            runs.append(run)
    launches = counters()
    got = check_seam_arms(runs, jobs, "schedule")
    assert all(len(v) == SERVER_COUNT for v in runs[0]["placed"].values())
    assert launches["place_closed_form"] == len(SEAM_ORDER) * len(jobs)
    assert all(launches[n] == 0 for n in launches if n != "place_closed_form")
    dirty = [len({node for _, node in runs[0]["placed"][j.id]}) for j in jobs[:-1]]
    arms = [
        {
            "seam": "on" if r["on"] else "off",
            "p50_ms": r["summary"]["p50_ms"], "seconds": r["summary"]["seconds"],
            "uploads": upload_summary(r["uploads"]), "post_commit": r["post"],
            "steady": r["steady"],
        }
        for r in runs
    ]
    out = {
        "passes": len(jobs), "counters_on": got, "dirty_rows_by_pass": dirty,
        "rows": runs[0]["uploads"][0]["rows"], "arms": arms,
        "eval_p50_ms": {
            seam: [a["p50_ms"] for a in arms if a["seam"] == seam] for seam in ("off", "on")
        },
    }
    log(f"[incremental] counters on (as predicted) {got}; dirty rows by pass {dirty}")
    for i, a in enumerate(arms):
        log(
            f"[incremental] arm {i} seam {a['seam']}: eval p50 {a['p50_ms']!r} ms; used "
            f"uploads in the evals {a['uploads']}; one pass after the last commit "
            f"{a['post_commit']}; steady state, {UPLOAD_REPEATS} uploads a kind {a['steady']}"
        )
    return launches, out


def incremental_kernel_arms(dev, n_nodes=PLUGIN_NODES):
    """The "incremental" path's kernel arms at 10,000 nodes, each run
    twice on fresh harnesses, the seam off and then on: spread (``SEAM_SPREAD_JOBS``: the
    one-per-value, chunked and value-scan kernels), hetero-maxmin (the
    hetero path's 12 jobs) and cp-pack (the cp path's 12 jobs: the
    score matrix, then the CP auction, each pass). Each arm is a path of
    its own ("incremental_spread", "incremental_hetero",
    "incremental_cp"), its counters zeroed just before it; its kernel
    calls are recorded for replay against the plain versions. Returns
    the launch counts by path, the recorded calls by path and kernel,
    and the summary."""
    from nomad_tpu_torch.device import cp as DC
    from nomad_tpu_torch.device import score as S
    from nomad_tpu_torch.scheduler import cp as SC
    from nomad_tpu_torch.scheduler import hetero as H

    routed = spread_jobs()
    mixed = mixed_fleet(n_nodes)
    arms = (
        ("incremental_spread", spread_fleet(n_nodes), [routed[i][1] for i in SEAM_SPREAD_JOBS],
         None, S.PlacementKernel, [(S, name) for name in COUPLED]),
        ("incremental_hetero", mixed, hetero_jobs(), "hetero-maxmin",
         H.HeteroPlacementKernel, [(H, "hetero_place")]),
        ("incremental_cp", mixed, cp_jobs(), "cp-pack", SC.CpPlacementKernel,
         [(DC, "cp_place")]),
    )
    launches, calls, out = {}, {}, {}
    for path, nodes, jobs, algorithm, cls, kernels in arms:
        zero_counters()
        with contextlib.ExitStack() as stack:
            rec = {name: stack.enter_context(recording(mod, name)) for mod, name in kernels}
            stack.enter_context(shared_recording(path, closed_form=False))
            runs = [seam_run(dev, nodes, jobs, on, algorithm, cls) for on in (False, True)]
        launches[path] = counters()
        calls[path] = rec
        got = check_seam_arms(runs, jobs, path)
        for name, c in rec.items():
            assert launches[path][name] == len(c), (path, name)
        assert sum(launches[path][name] for _, name in kernels) >= 2 * len(jobs), launches[path]
        assert launches[path]["place_closed_form"] == 0, launches[path]
        out[path] = {
            "evals": len(jobs), "counters_on": got,
            "uploads": {"off": upload_summary(runs[0]["uploads"]),
                        "on": upload_summary(runs[1]["uploads"])},
            "eval_p50_ms": {"off": runs[0]["summary"]["p50_ms"],
                            "on": runs[1]["summary"]["p50_ms"]},
        }
        log(
            f"[{path}] seam on = off on {len(runs[0]['passes'])} passes; counters on (as "
            f"predicted) {got}; launches {launches[path]}; used uploads {out[path]['uploads']}"
        )
    return launches, calls, out


def batch_path(dev, nodes, jobs):
    """The "batch" path: the schedule path's evals prepared against one
    ClusterTensors and merged into ONE closed-form call
    (``Harness.process_merged``: concatenated asks, ``lane_groups``, one
    ``kernel.place``, ``repair_batch_conflicts``, ``build_batch_plan``
    per eval, submit, ``complete_merged_attempt``). Every alloc placed,
    no rejected or over-committed node. Returns the launch counts, the
    summary and the harness."""
    from nomad_tpu_torch.device import score as S

    h = fleet_harness(dev, nodes, jobs)
    evs = [eval_of(h, j, "batch") for j in jobs]
    host = {}
    zero_counters()
    with shared_recording("batch", score_matrix=False), \
            timing(S, "repair_batch_conflicts", host), \
            timing(S.PlacementKernel, "place", host):
        t0 = time.perf_counter()
        out = h.process_merged(evs)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = counters()
    allocs = live(h, jobs)
    rejected = sum(len(r.rejected_nodes) for r in h.results)
    over = committed_overcommit(h.store)
    conflicts = sum(1 for ok in out["lane_ok"] if not ok)
    summary = {
        "evals": len(evs), "lanes": out["lanes"], "merged": len(out["merged"]),
        "individual": len(out["individual"]), "placed": len(allocs),
        "host_seconds": seconds, "kernel_place_seconds": host["place"],
        "repair_seconds": host["repair_batch_conflicts"],
    }
    log(
        f"[batch] {len(evs)} evals merged into {launches['place_closed_form']} closed-form "
        f"call(s) in {seconds:.3f} s (kernel.place {host['place']:.3f} s, repair "
        f"{host['repair_batch_conflicts']:.3f} s); {summary}; lanes given up {conflicts}; "
        f"rejected plan nodes {rejected}; over-committed nodes {over}; launches {launches}"
    )
    assert out["merged"] == [ev.id for ev in evs] and not out["individual"], out
    assert all(out["completed"].values())
    assert len(allocs) == len(jobs) * SERVER_COUNT, "not every alloc was placed"
    assert rejected == 0 and over == 0
    assert sorted({e.status for e in h.evals}) == ["complete"]
    assert launches["place_closed_form"] == 1
    assert all(launches[n] == 0 for n in launches if n != "place_closed_form")
    return launches, summary, h


def plan_path(dev, h):
    """The "plan" path: ``plan_job`` (the dry-run ``job plan``) of a new
    service job of ``PLAN_COUNT`` allocs on the batch path's store at
    10,000 nodes: every alloc annotated for placement, no failed group,
    explanations inline, nothing committed. Returns the launch counts
    and the summary."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.scheduler.annotate import plan_job

    job = mock.job()
    job.id = "planned"
    job.task_groups[0].count = PLAN_COUNT
    allocs_before = len(list(h.store.allocs()))
    zero_counters()
    with shared_recording("plan", score_matrix=False):
        t0 = time.perf_counter()
        out = plan_job(h.store, job, device=dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = counters()
    ann = out["annotations"]
    log(
        f"[plan] plan_job at {SERVER_NODES} nodes in {seconds:.3f} s: annotations {ann}; "
        f"failed groups {sorted(out['failed_tg_allocs'])}; explanations for "
        f"{sorted(out['placement_explanations'])}; launches {launches}"
    )
    assert ann == {"web": {"place": PLAN_COUNT, "stop": 0, "preemptions": 0}}, ann
    assert not out["failed_tg_allocs"] and "web" in out["placement_explanations"]
    assert h.store.job_by_id(job.namespace, job.id) is None
    assert len(list(h.store.allocs())) == allocs_before
    assert launches["place_closed_form"] >= 1
    assert all(launches[n] == 0 for n in launches if n != "place_closed_form")
    return launches, {"seconds": seconds, "annotations": ann}


# bench_torch.py's end-to-end bench at bench.py's end_to_end shape
SERVER_BENCH = {"n_nodes": 10_000, "n_jobs": 100, "per_job": 250}


def server_path(dev):
    """The "server" path: ``bench_torch.bench_end_to_end`` on the card at
    ``SERVER_BENCH`` — the port's server (broker, one batching worker
    with its pipelined commit thread, plan queue, applier) schedules
    bench.py's end_to_end jobs (spread + affinity, mixed service/batch)
    after its warmup and drain. Every closed-form and coupled call is
    recorded from both threads. Drained, no unaccounted alloc, no
    over-committed node, no failed eval, no swallowed exception in the
    worker or the applier and no batched pass retried solo (a failing
    launch would hide there). Returns the launch counts, the coupled
    calls by kernel and the bench's result."""
    import bench_torch
    from nomad_tpu_torch.device import score as S

    zero_counters()
    with contextlib.ExitStack() as stack:
        stack.enter_context(shared_recording("server", score_matrix=False))
        coupled = {name: stack.enter_context(recording(S, name)) for name in COUPLED}
        t0 = time.perf_counter()
        out = bench_torch.bench_end_to_end(**SERVER_BENCH, device=dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = counters()
    log(
        f"[server] bench_torch at {out['config']} on {out['card']}: "
        f"allocs_per_sec={out['allocs_per_sec']!r} evals_per_sec={out['evals_per_sec']!r} "
        f"eval p50_ms={out['eval_latency_ms']['p50']!r} "
        f"p99_ms={out['eval_latency_ms']['p99']!r} "
        f"({out['eval_latency_ms']['evals']} evals); elapsed {out['elapsed_s']!r} s of a "
        f"{seconds:.1f} s path; placed {out['placed']}/{out['total']}, unaccounted "
        f"{out['unaccounted_allocs']}, failed evals {out['failed_evals']}, over-committed "
        f"nodes {out['committed_overcommit']}, swallowed {out['swallowed']}; launches {launches}"
    )
    for key in ("phase_breakdown_ms", "commit_train", "batch", "device_cache"):
        log(f"[server] {key} " + json.dumps(out[key], sort_keys=True))
    assert out["drained"], "the server did not drain"
    assert out["unaccounted_allocs"] == 0 and out["warm_allocs_live_at_start"] == 0
    assert out["committed_overcommit"] == 0, "a node is over-committed in the store"
    assert out["failed_evals"] == 0
    assert not any(out["swallowed"].values()), out["swallowed"]
    for name, calls in coupled.items():
        assert len(calls) == launches[name], (name, len(calls), launches[name])
    assert launches["place_spread_opv"] > 0
    off = (*PREEMPT_COUNTS, *PLUGIN, "migrate_plan", "score_matrix")
    assert all(launches[n] == 0 for n in off), launches
    out["path_seconds"] = seconds
    return launches, coupled, out


def calib_path(dev):
    """The "calib" path: ``run_calib_ab`` at its defaults on the card (the
    hetero A/B rerun with throughputs learned from synthetic execute
    spans through a flight recorder). Its gate holds and declared mode is
    byte-identical; every hetero-greedy call is recorded and replayed
    against its plain version afterwards. Returns the launch counts, the
    recorded hetero calls and the report."""
    from nomad_tpu_torch.obs.calibrate import run_calib_ab
    from nomad_tpu_torch.scheduler import hetero as H

    zero_counters()
    with recording(H, "hetero_place") as calls, shared_recording("calib"):
        t0 = time.perf_counter()
        report = run_calib_ab(device=dev)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = counters()
    log(
        f"[calib] run_calib_ab in {seconds:.3f} s; report "
        f"{json.dumps(report, sort_keys=True)}; launches {launches}"
    )
    assert report["ok"], report["ab"]
    assert report["declared_mode_identical"] is True
    est = report["estimator"]
    assert est["learned_cells"] == est["cell_count"] > 0
    assert launches["hetero_place"] == len(calls) > 0
    assert report["added_retraces"] == 0, report["added_retraces"]
    return launches, calls, {
        "seconds": seconds, "ok": report["ok"], "ab": report["ab"],
        "added_retraces": report["added_retraces"],
    }


def restore_path(dev, h):
    """The "restore" path: the preempt path's store (10,000 nodes full of
    ballast, the preemptors' and the system path's allocs) saved with
    ``save_snapshot`` and restored with ``restore_snapshot`` through the
    restricted unpickler; every table the same size, and one new service
    eval (``RESTORE_COUNT`` small allocs) scheduled on the restored store
    and on the original to the same plan. Returns the launch counts and
    the summary."""
    import tempfile

    from nomad_tpu_torch import mock
    from nomad_tpu_torch.scheduler import Harness
    from nomad_tpu_torch.state.snapshot import restore_snapshot, save_snapshot

    from nomad_tpu_torch.backend import BUILD_DIR

    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:  # inside the checkout
        path = f"{tmp}/state.snap"
        t0 = time.perf_counter()
        index = save_snapshot(h.store, path)
        save_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        t0 = time.perf_counter()
        restored = restore_snapshot(path)
        restore_s = time.perf_counter() - t0
    sizes = {}
    for what, store in (("saved", h.store), ("restored", restored)):
        snap = store.snapshot()
        sizes[what] = (len(list(snap.nodes())), len(list(snap.jobs())),
                       len(list(snap.allocs())), len(list(snap.evals())))
    job = mock.job()
    job.id = "after-restore"
    job.task_groups[0].count = RESTORE_COUNT
    res = job.task_groups[0].tasks[0].resources
    res.cpu, res.memory_mb = RESTORE_ASK
    plans = []
    zero_counters()
    with shared_recording("restore", score_matrix=False):
        for hh in (Harness(restored, device=dev), h):
            hh.store.upsert_job(hh.next_index(), copy.deepcopy(job))
            hh.process(eval_of(hh, job, "restore"))
            plans.append(sorted(
                (a.name, a.node_id) for a in hh.store.allocs_by_job(job.namespace, job.id)
            ))
    launches = counters()
    log(
        f"[restore] snapshot at index {index}: {size} bytes; save {save_s:.3f} s, "
        f"restore {restore_s:.3f} s; (nodes, jobs, allocs, evals) saved {sizes['saved']} "
        f"restored {sizes['restored']}; one eval of {RESTORE_COUNT} allocs on each "
        f"store: same plan {plans[0] == plans[1]}; launches {launches}"
    )
    assert sizes["saved"] == sizes["restored"]
    assert plans[0] == plans[1] and len(plans[0]) == RESTORE_COUNT
    assert launches["place_closed_form"] == 2
    assert all(launches[n] == 0 for n in launches if n != "place_closed_form")
    return launches, {
        "save_s": save_s, "restore_s": restore_s, "bytes": size,
        "allocs": sizes["restored"][2], "nodes": sizes["restored"][0],
    }


LEADER_NODES = 10_000
LEADER_THIN_JOBS = 40
LEADER_THIN_COUNT = 250
LEADER_FILLER_ASK = (3000, 1024)  # MHz, MiB: one a node, two never fit
LEADER_THIN_ASK = (800, 512)  # one beside each filler
LEADER_DRAIN_NODES = 100
LEADER_DRAIN_DEADLINE_S = 600.0
LEADER_CYCLES = 4
LEADER_BUDGET = 512
LEADER_MIN_CANDIDATES = 5_000
CLIENT_BATCH = 2_000  # allocs a client update carries
CLIENT_POLL_S = 0.1


def client_flip(server) -> int:
    """The fake client: every alloc placed to run and still pending comes
    up running, reported through ``update_allocs_from_client`` in batches
    of ``CLIENT_BATCH``. Returns how many it flipped."""
    ups = []
    for a in server.store.allocs():
        if a.desired_status == "run" and a.client_status == "pending":
            u = copy.copy(a)
            u.client_status = "running"
            ups.append(u)
    for i in range(0, len(ups), CLIENT_BATCH):
        server.update_allocs_from_client(ups[i:i + CLIENT_BATCH])
    return len(ups)


@contextlib.contextmanager
def fake_client(server):
    """``client_flip`` every ``CLIENT_POLL_S`` on a thread of its own while
    the block runs (the reference fixture's client loop)."""
    stop = threading.Event()

    def loop():
        while not stop.wait(CLIENT_POLL_S):
            client_flip(server)

    t = threading.Thread(target=loop, name="fake-client", daemon=True)
    t.start()
    try:
        yield
    finally:
        stop.set()
        t.join(timeout=30)


def settle(server, timeout=600.0):
    """No eval ready or in flight and no alloc left pending."""
    while True:
        assert server.wait_for_evals(timeout=timeout), "the server did not drain"
        if client_flip(server) == 0:
            return


def fleet_efficiency(store) -> float:
    """Packing efficiency of the ready nodes, computed as the defrag
    controller computes it at the top of a cycle."""
    from nomad_tpu_torch.device.migrate import packing_efficiency
    from nomad_tpu_torch.structs.resources import node_comparable_capacity

    nodes = [n for n in store.nodes() if n.ready()]
    capacity = np.stack([node_comparable_capacity(n).to_vector() for n in nodes])
    used = np.zeros_like(capacity)
    for i, n in enumerate(nodes):
        for a in store.allocs_by_node(n.id):
            if not a.terminal_status():
                used[i] += a.comparable_resources().to_vector()
    return packing_efficiency(capacity, used, np.ones(len(nodes), dtype=bool))


def defrag_pairs(store) -> set:
    """Ids of the live defrag replacements. Each must be the pair that law
    16 names: its source stopped with the phase-B description."""
    from nomad_tpu_torch.server.defrag import DEFRAG_DESC, DEFRAG_STOP_DESC

    out = set()
    for a in store.allocs():
        if a.terminal_status() or a.desired_description != DEFRAG_DESC:
            continue
        old = store.alloc_by_id(a.previous_allocation)
        assert old is not None and old.desired_status == "stop", (a.id, old)
        assert old.desired_description == DEFRAG_STOP_DESC, old.desired_description
        out.add(a.id)
    return out


def live_by_job(store, prefix) -> dict:
    out = collections.Counter()
    for a in store.allocs():
        if a.job_id.startswith(prefix) and not a.terminal_status():
            out[a.job_id] += 1
    return dict(out)


def leader_jobs():
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs import Resources

    def job(job_id, count, ask):
        j = mock.job(id=job_id, name=job_id)
        j.task_groups[0].count = count
        j.task_groups[0].tasks[0].resources = Resources(cpu=ask[0], memory_mb=ask[1])
        return j

    filler = job("filler", LEADER_NODES, LEADER_FILLER_ASK)
    thin = [job(f"thin-{i:02d}", LEADER_THIN_COUNT, LEADER_THIN_ASK)
            for i in range(LEADER_THIN_JOBS)]
    return filler, thin


def leader_drain(server):
    """Drain ``LEADER_DRAIN_NODES`` nodes through ``update_node_drain``
    with a deadline, the fake client running. Returns the seconds from the
    first drain call until every drained node is done and empty."""
    from nomad_tpu_torch.structs import DrainStrategy

    victims = sorted(n.id for n in server.store.nodes())[:LEADER_DRAIN_NODES]
    per_job = collections.Counter(
        a.job_id for v in victims for a in server.store.allocs_by_node(v)
        if not a.terminal_status()
    )
    on_victims = sum(per_job.values())
    with fake_client(server):
        t0 = time.perf_counter()
        for v in victims:
            server.update_node_drain(v, DrainStrategy(deadline_s=LEADER_DRAIN_DEADLINE_S))
        while True:
            nodes = [server.store.node_by_id(v) for v in victims]
            left = sum(
                1 for v in victims for a in server.store.allocs_by_node(v)
                if not a.terminal_status()
            )
            if left == 0 and all(n.drain is None for n in nodes):
                break
            assert time.perf_counter() - t0 < LEADER_DRAIN_DEADLINE_S, (left, "drain stuck")
            time.sleep(0.05)
        seconds = time.perf_counter() - t0
        settle(server)
    nodes = [server.store.node_by_id(v) for v in victims]
    assert all(n.scheduling_eligibility == "ineligible" for n in nodes)
    # with max_parallel 1 a job's allocs leave one wave at a time: the
    # drain takes at least as many waves as the most any job had there
    return seconds, on_victims, victims, max(per_job.values())


def leader_cycles(server, calls, dev):
    """``LEADER_CYCLES`` direct ``run_cycle`` calls, each followed by the
    fake client and the gates. ``calls`` is the recorder's list of the
    controller's ``migrate_plan`` calls. Returns a row a cycle."""
    from nomad_tpu_torch.scheduler import migrate as SM
    from nomad_tpu_torch.server import defrag as D
    from nomad_tpu_torch.utils.metrics import global_metrics

    host = {}
    rows = []
    seen = defrag_pairs(server.store)
    thin_before = live_by_job(server.store, "thin-")
    with timing(SM, "build_defrag_batch", host), timing(SM, "_on", host), \
            timing(D.DefragController, "_execute_move", host):
        for cycle in range(LEADER_CYCLES):
            eff_before = fleet_efficiency(server.store)
            host.clear()
            n_calls = len(calls)
            t0 = time.perf_counter()
            completed = server.defrag.run_cycle()
            cycle_s = time.perf_counter() - t0
            split = dict(host)
            settle(server)
            assert len(calls) == n_calls + 1, "the cycle did not plan through migrate_plan"
            c = calls[-1]
            a, n = c["scores"].shape
            pairs = defrag_pairs(server.store)
            new_pairs = pairs - seen
            seen = pairs
            eff_after = fleet_efficiency(server.store)
            metric_counts = global_metrics.snapshot()["counters"]
            row = {
                "cycle": cycle + 1, "A": a, "N": n, "completed_moves": completed,
                "new_pairs": len(new_pairs),
                "efficiency_before": eff_before, "efficiency_after": eff_after,
                "kernel_event_ms": c.get("event_ms"), "plan_host_s": c.get("host_s"),
                "cycle_host_s": cycle_s,
                "build_defrag_batch_s": split.get("build_defrag_batch", 0.0),
                "upload_s": split.get("_on", 0.0),
                "moves_commit_s": split.get("_execute_move", 0.0),
                "capacity_violations": int(
                    metric_counts.get("nomad.migrate.capacity_violations", 0)),
                "over_committed_nodes": committed_overcommit(server.store),
            }
            row["snapshot_and_candidates_s"] = cycle_s - sum(
                row[k] or 0.0 for k in ("build_defrag_batch_s", "upload_s", "moves_commit_s",
                                        "plan_host_s")
            )
            log(f"[leader] defrag cycle {json.dumps(row, sort_keys=True)}")
            assert server.defrag.last_efficiency == eff_before
            assert a >= LEADER_MIN_CANDIDATES, f"defrag: only {a} candidates"
            assert 0 < completed <= LEADER_BUDGET
            assert len(new_pairs) == completed, (len(new_pairs), completed)
            assert row["capacity_violations"] == 0 and row["over_committed_nodes"] == 0
            assert live_by_job(server.store, "thin-") == thin_before, "a thin job lost an alloc"
            assert eff_after > eff_before, (eff_before, eff_after)
            rows.append(row)
    return rows


def leader_path(dev, n_nodes=LEADER_NODES):
    """The "leader" path: a server with every leader service running at
    ``n_nodes`` on the fragmentation recipe, a drain, ``LEADER_CYCLES``
    defrag cycles planned on the card, then ``bench_torch``'s end-to-end
    bench with admission on. The counters are zeroed just before and read
    just after; every ``migrate_plan`` call is recorded (and timed by CUDA
    events) for the replay, the closed-form calls into ``SHARED_CALLS``,
    the coupled calls for their own replay. Returns the launch counts, the
    labelled ``migrate_plan`` calls, the coupled calls and a summary."""
    import bench_torch
    from nomad_tpu_torch.device import score as S
    from nomad_tpu_torch.server import Server, ServerConfig
    from nomad_tpu_torch.utils.metrics import global_metrics

    M = migrate_module()
    filler, thin = leader_jobs()
    zero_counters()
    t_path = time.perf_counter()
    with contextlib.ExitStack() as stack:
        stack.enter_context(shared_recording("leader", score_matrix=False))
        coupled = {name: stack.enter_context(recording(S, name)) for name in COUPLED}
        calls = stack.enter_context(recording(
            M, "migrate_plan", cls=TimedRecorder if dev.type == "cuda" else Recorder))
        global_metrics.reset()
        server = Server(ServerConfig(
            num_workers=1, num_batch_workers=1, defrag_budget=LEADER_BUDGET, device=dev,
        ))
        server.establish_leadership()
        try:
            from nomad_tpu_torch import mock

            t0 = time.perf_counter()
            for i in range(n_nodes):
                server.register_node(mock.node(id=f"leader-{i:05d}", name=f"leader-{i:05d}"))
            server.register_job(filler)
            settle(server)
            for j in thin:
                server.register_job(j)
            settle(server)
            server.deregister_job("default", "filler")
            settle(server)
            setup_s = time.perf_counter() - t0
            thin_live = live_by_job(server.store, "thin-")
            thin_nodes = {a.node_id for a in server.store.allocs()
                          if a.job_id.startswith("thin-") and not a.terminal_status()}
            log(
                f"[leader] set-up {setup_s:.3f} s: {n_nodes} nodes, filler of {n_nodes} "
                f"deregistered, {sum(thin_live.values())} thin allocs on {len(thin_nodes)} "
                f"nodes; efficiency {fleet_efficiency(server.store)!r}"
            )
            assert thin_live == {j.id: LEADER_THIN_COUNT for j in thin}
            assert len(thin_nodes) == min(n_nodes, LEADER_THIN_JOBS * LEADER_THIN_COUNT)
            drain_s, drained, victims, waves = leader_drain(server)
            after_drain = live_by_job(server.store, "thin-")
            log(
                f"[leader] drain of {len(victims)} nodes ({drained} allocs on them, at "
                f"most {waves} of one job: as many waves) {drain_s:.3f} s; counters "
                + json.dumps({k: v for k, v in global_metrics.snapshot()["counters"].items()
                              if k.startswith("nomad.drain.")}, sort_keys=True)
            )
            assert after_drain == thin_live, "an alloc of a drained node is unaccounted for"
            assert not any(
                not a.terminal_status() for v in victims for a in server.store.allocs_by_node(v)
            )
            cycles = leader_cycles(server, calls, dev)
            metric_counts = global_metrics.snapshot()["counters"]
            swallowed = {k: int(v) for k, v in metric_counts.items()
                         if k.endswith(".swallowed_errors")}
            migrate_counters = {k: int(v) for k, v in sorted(metric_counts.items())
                                if k.startswith("nomad.migrate.")}
            adm = server.admission.snapshot()
            services = {
                name: getattr(server, name)._thread is not None
                and getattr(server, name)._thread.is_alive()
                for name in ("heartbeater", "deployment_watcher", "drainer", "defrag",
                             "periodic", "core_gc", "volume_watcher")
            }
        finally:
            server.shutdown()
        assert all(services.values()), services
        assert not swallowed, swallowed
        log(f"[leader] migrate counters {json.dumps(migrate_counters, sort_keys=True)}; "
            f"admission level {adm['level']}, services running {services}")
        del server
        t0 = time.perf_counter()
        bench = bench_torch.bench_end_to_end(**SERVER_BENCH, device=dev)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        bench_s = time.perf_counter() - t0
    launches = counters()
    seconds = time.perf_counter() - t_path
    log(
        f"[leader] bench_torch with every service on {bench['card']}: allocs_per_sec="
        f"{bench['allocs_per_sec']!r} evals_per_sec={bench['evals_per_sec']!r} eval p50_ms="
        f"{bench['eval_latency_ms']['p50']!r} p99_ms={bench['eval_latency_ms']['p99']!r}; "
        f"elapsed {bench['elapsed_s']!r} s of {bench_s:.1f} s; placed {bench['placed']}/"
        f"{bench['total']}, unaccounted {bench['unaccounted_allocs']}, failed evals "
        f"{bench['failed_evals']}, over-committed {bench['committed_overcommit']}, swallowed "
        f"{bench['swallowed']}; admission {json.dumps(bench['admission'], sort_keys=True)}"
    )
    log(f"[leader] path {seconds:.1f} s; launches {launches}")
    assert bench["drained"]
    assert bench["placed"] == bench["total"] == SERVER_BENCH["n_jobs"] * SERVER_BENCH["per_job"]
    assert bench["unaccounted_allocs"] == 0 and bench["failed_evals"] == 0
    assert bench["committed_overcommit"] == 0
    assert not any(bench["swallowed"].values()), bench["swallowed"]
    assert bench["admission"]["conserved"] and bench["admission"]["shed"] == 0
    assert launches["migrate_plan"] == len(calls) == LEADER_CYCLES
    assert launches["place_closed_form"] > 0 and launches["place_spread_opv"] > 0
    for name, rec in coupled.items():
        assert len(rec) == launches[name], (name, len(rec), launches[name])
    summary = {
        "nodes": n_nodes, "drain_s": drain_s, "drained_allocs": drained, "drain_waves": waves,
        "drained_nodes": len(victims), "cycles": cycles, "migrate_counters": migrate_counters,
        "bench": {k: bench[k] for k in (
            "config", "card", "allocs_per_sec", "evals_per_sec", "eval_latency_ms",
            "elapsed_s", "placed", "total", "unaccounted_allocs", "failed_evals",
            "committed_overcommit", "swallowed", "admission", "phase_breakdown_ms",
        )},
        "path_seconds": seconds,
    }
    labelled = [(f"leader cycle {i + 1}", c) for i, c in enumerate(calls)]
    return launches, labelled, coupled, summary


# -- phase 5, the "resilience" path --------------------------------------------

RESILIENCE_NODES = 1_000  # a mid-sized production fleet
# cut from the reference's acceptance length, 200 (tests/test_chaos.py),
# for time: the runner drains every op before the next (C-P4), one
# scheduling pass an op
RESILIENCE_STEPS = 100
RESILIENCE_SEEDS = (1, 2, 1)  # seed 1 twice: its canonical reports must match
# the reference's test_migration_exercised_in_default_mix (its 6 nodes)
MIGRATION_MIX = {"seed": 11, "steps": 60}
# one explicit hang, run when the default mix fired no kernel fault
HANG_EXPLICIT = {"seed": 23, "steps": 40}
# the reference's test_hang_rate_run_places_everything, on the card
HANG_SLICE = {"seed": 31, "steps": 60, "faults": ("hang",), "rate": 0.10}
# bench.py soak's defaults (update, stop, drain and flap fractions too)
SOAK = {"seed": 7, "seconds": 30.0, "rate": 25.0, "nodes": 10_000, "batch_workers": 1}
# bench.py soak --saturation's defaults
SATURATION = {"seed": 7, "nodes": 200, "probe_seconds": 2.0, "lo": 4.0, "hi": 128.0,
              "iterations": 5}
GUARD_CALLS = 1_000  # calls timed through the guard, and as many straight
# laws the checker skips, on the CPU as on the card, while the state they
# judge does not exist: a score view (incremental rescoring off), a CP
# pass in this process, a planned move in this process
LAWS_SKIPPED_WITHOUT_STATE = {
    "shard_consistency", "cp_assignment_conservation", "migration_conservation",
}
RESILIENCE_METRICS = {
    "breaker_trips": "nomad.resilience.trips_total",
    "refused_calls": "nomad.resilience.refused_calls",
    "abandoned_skips": "nomad.resilience.abandoned_skips",
    "fallback_calls": "nomad.resilience.fallback_calls",
    "fallback_passes": "nomad.resilience.fallback_passes",
    "migrate_planned": "nomad.migrate.planned",
    # where a refused or timed-out call lands when no eval is nacked for
    # it: a batched pass that retries its evals solo, a defrag cycle
    "batch_kernel_errors": "nomad.worker.batch_kernel_errors",
    "defrag_cycle_errors": "defrag.swallowed_errors",
}


def metric_deltas(before: dict) -> dict:
    from nomad_tpu_torch.utils.metrics import global_metrics

    now = global_metrics.snapshot()["counters"]
    return {k: int(now.get(m, 0) - before.get(m, 0)) for k, m in RESILIENCE_METRICS.items()}


def chaos_on(dev, label, **kw):
    """One ``run_chaos`` on ``dev`` with the launch counts zeroed just
    before it and read just after; its line of figures."""
    from nomad_tpu_torch.chaos import run_chaos
    from nomad_tpu_torch.chaos.invariants import INVARIANTS
    from nomad_tpu_torch.utils.metrics import global_metrics

    before = global_metrics.snapshot()["counters"]
    zero_counters()
    t0 = time.perf_counter()
    run = run_chaos(device=dev, **kw)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = counters()
    broker = run.report.info["broker"]
    summary = {
        "label": label, "seed": run.seed, "steps": run.steps, "ok": run.ok,
        "seconds": seconds,
        "faults_fired": dict(collections.Counter(a for _s, _n, a in run.triggered)),
        "kernel_faults": [list(t) for t in run.triggered if t[0].startswith("kernel.")],
        **metric_deltas(before),
        "nacks": broker["nacks"], "unack_timeouts": broker["unack_timeouts"],
        "kernel_refusals": run.report.info["kernel_refusals"],
        "checked": sorted(run.report.checked),
        "launches": {k: v for k, v in launches.items() if v},
    }
    log(f"[resilience] {label} on {dev.type}: " + json.dumps(summary, sort_keys=True))
    assert run.ok, run.render()
    skipped = set(INVARIANTS) - set(run.report.checked)
    assert skipped <= LAWS_SKIPPED_WITHOUT_STATE, skipped
    assert summary["fallback_calls"] == 0 and summary["fallback_passes"] == 0, summary
    refusals = summary["kernel_refusals"]
    assert refusals["ended_placed"] + refusals["parked_failed"] == refusals["evals"], refusals
    return run, summary, launches


def guard_cost(dev) -> dict:
    """µs a synchronized ``place_closed_form`` call at the schedule path's
    shape through the kernel guard and straight, ``GUARD_CALLS`` each, in
    alternating blocks of 100 (host clock, one synchronize after each
    call in both arms)."""
    from nomad_tpu_torch.backend import direct_launches as straight
    from nomad_tpu_torch.device import score as S

    args, max_j, k = schedule_inputs(dev)
    call = lambda: S.place_closed_form(*args, False, max_j, k)  # noqa: E731
    want = S.place_closed_form_plain(*args, False, max_j, k)
    for _ in range(10):
        got = call()
    with straight():
        for _ in range(10):
            call()
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want)), "guarded call differs"
    seconds = {"guarded": 0.0, "straight": 0.0}
    for _ in range(GUARD_CALLS // 100):
        for arm in ("guarded", "straight"):
            with straight() if arm == "straight" else contextlib.nullcontext():
                t0 = time.perf_counter()
                for _ in range(100):
                    call()
                    torch.cuda.synchronize()
                seconds[arm] += time.perf_counter() - t0
    out = {f"{arm}_us_per_call": s / GUARD_CALLS * 1e6 for arm, s in seconds.items()}
    out["calls"] = GUARD_CALLS
    log(f"[resilience] guard cost at the schedule shape (G 1, N 16,384): " + json.dumps(out))
    return out


def resilience_path(dev):
    """The "resilience" path: the kernel guard in front of every launch,
    driven under faults on the port's server on the card.

    1. ``run_chaos`` at ``RESILIENCE_NODES`` × ``RESILIENCE_STEPS`` under
       the default fault mix for ``RESILIENCE_SEEDS`` (seed 1 twice): every
       run ``ok``, seed 1's two canonical reports identical and equal to
       the same run's on the CPU; every law checked, or skipped for
       want of the state it judges (``LAWS_SKIPPED_WITHOUT_STATE``);
       then ``MIGRATION_MIX``, which moves allocs live; a kernel fault
       fired on a real launch (else one explicit hang run); no call
       finished on a fallback; closed-form and migration launches.
    2. The degraded slice (``HANG_SLICE``): ``ok``, a trip, every refused
       eval accounted for.
    3. ``run_soak`` at ``SOAK``: invariants clean, the SLO schema pinned,
       completions ≥ 0.8 × arrivals, no trip, nothing swallowed.
    4. ``saturation_search`` at ``SATURATION``.
    5. The guard's cost (``guard_cost``).
    Returns a summary of every figure."""
    from nomad_tpu_torch.chaos import FaultSpec
    from nomad_tpu_torch.obs import loadgen
    from nomad_tpu_torch.obs.slo import SLO_SCHEMA, slo_schema_of
    from nomad_tpu_torch.resilience import breaker

    t_path = time.perf_counter()
    out = {"chaos": [], "card": card_line()}
    launches = collections.Counter()
    canonical = {}
    for seed in RESILIENCE_SEEDS:
        run, summary, counts = chaos_on(
            dev, f"chaos seed {seed}", seed=seed, steps=RESILIENCE_STEPS,
            nodes=RESILIENCE_NODES,
        )
        out["chaos"].append(summary)
        launches.update(counts)
        canonical.setdefault(seed, []).append(run.canonical_json())
    assert canonical[1][0] == canonical[1][1], "seed 1's canonical reports differ"
    cpu_run, cpu_summary, _ = chaos_on(
        torch.device("cpu"), "chaos seed 1", seed=1, steps=RESILIENCE_STEPS,
        nodes=RESILIENCE_NODES,
    )
    assert cpu_run.canonical_json() == canonical[1][0], "seed 1 on the card differs from the CPU"
    out["cpu_seed1_seconds"] = cpu_summary["seconds"]
    # the reference's migration-in-the-default-mix run: live moves, so the
    # defrag controller's migration kernel launches under faults too (at
    # RESILIENCE_NODES the allocs come up after the last client flip)
    _, summary, counts = chaos_on(dev, "migration mix", **MIGRATION_MIX)
    out["chaos"].append(summary)
    launches.update(counts)
    if not any(s["kernel_faults"] for s in out["chaos"]):
        _, summary, counts = chaos_on(
            dev, "explicit hang", **HANG_EXPLICIT,
            schedule=[FaultSpec("kernel.hang", 0, "hang", 0.3)],
        )
        out["chaos"].append(summary)
        launches.update(counts)
    assert any(s["kernel_faults"] for s in out["chaos"]), "no kernel fault fired"
    assert launches["place_closed_form"] > 0 and launches["migrate_plan"] > 0, launches
    out["chaos_launches"] = dict(launches)

    _, hang, _ = chaos_on(dev, "hang slice", **HANG_SLICE)
    assert hang["breaker_trips"] >= 1, hang
    out["hang_slice"] = hang

    zero_counters()
    t0 = time.perf_counter()
    soak = loadgen.run_soak(**SOAK, device=dev)
    torch.cuda.synchronize()
    soak_launches = {k: v for k, v in counters().items() if v}
    slo = soak.slo
    ev, t = slo["eval_latency_ms"], slo["throughput"]
    out["soak"] = {
        "config": SOAK, "seconds": time.perf_counter() - t0, "ok": soak.ok,
        "eval_latency_ms": {k: ev[k] for k in ("count", "p50_ms", "p95_ms", "p99_ms", "max_ms")},
        "placement_p99_ms": slo["placement_latency_ms"]["p99_ms"],
        "arrivals": t["arrivals"], "completions": t["completions"],
        "arrival_rate_per_s": t["arrival_rate_per_s"],
        "completion_rate_per_s": t["completion_rate_per_s"],
        "queue_depth": slo["queue_depth"], "verdict": slo["verdict"],
        "counters": {k: v for k, v in slo["counters"].items() if v},
        "workload": soak.workload, "launches": soak_launches,
    }
    log("[resilience] soak " + json.dumps(out["soak"], sort_keys=True))
    assert soak.ok, soak.render(verbose=True)
    assert slo_schema_of(slo) == SLO_SCHEMA
    assert t["completions"] >= 0.8 * t["arrivals"], t
    assert slo["counters"]["breaker_trips"] == 0, slo["counters"]
    assert slo["counters"]["swallowed_errors"] == 0, slo["counters"]
    assert slo["counters"]["fallback_activations"] == 0, slo["counters"]
    assert soak_launches.get("place_closed_form", 0) > 0, soak_launches

    probes = []
    t0 = time.perf_counter()
    rate = loadgen.saturation_search(**SATURATION, device=dev, log=probes.append)
    for line in probes:
        log(f"[resilience] {line}")
    out["saturation"] = {"config": SATURATION, "saturation_rate": rate,
                         "probes": probes, "seconds": time.perf_counter() - t0}
    log(f"[resilience] saturation_rate {rate!r}/s over {len(probes)} probes")

    out["guard"] = guard_cost(dev)
    breaker.reset_all()
    out["seconds"] = time.perf_counter() - t_path
    log(
        f"[resilience] path {out['seconds']:.1f} s (chaos runs at {RESILIENCE_STEPS} steps: "
        f"cut from the reference's 200 for time)"
    )
    return out


REPO_DIR = os.path.dirname(os.path.abspath(__file__))
AGENT_READY_S = 180.0  # the subprocess imports torch and opens a CUDA context
AGENT_STOP_S = 15.0  # SIGINT to exit
AGENT_CLI_TIMEOUT_S = 120.0
AGENT_JOB_HCL = """
job "web" {
  type = "batch"
  group "web" {
    count = 3
    task "web" {
      driver = "mock_driver"
      config {
        run_for = 0.05
      }
      resources {
        cpu    = 100
        memory = 64
      }
    }
  }
}
"""
FALLBACK_CALLS = "nomad.resilience.fallback_calls"


def agent_cli(*argv, addr=None):
    """One ``python -m nomad_tpu_torch.cli`` command against ``addr``:
    its standard output and seconds. Any exit code but 0 fails."""
    cmd = [sys.executable, "-m", "nomad_tpu_torch.cli"]
    if addr is not None:
        cmd += ["--address", addr]
    t0 = time.perf_counter()
    proc = subprocess.run(
        [*cmd, *argv], cwd=REPO_DIR, capture_output=True, text=True,
        timeout=AGENT_CLI_TIMEOUT_S,
    )
    seconds = time.perf_counter() - t0
    assert proc.returncode == 0, (argv, proc.returncode, proc.stdout[-2000:], proc.stderr[-2000:])
    return proc.stdout, seconds


def agent_cli_path(dev):
    """Part (a) of the "agent" path: the port as a user starts it.
    ``python -m nomad_tpu_torch.cli agent -dev --bind 127.0.0.1:0`` (the
    server's kernels on the card, its default) in a subprocess; ``job
    run`` of an HCL batch job (3 x ``mock_driver``, 0.05 s); ``job
    status`` until every alloc is ``complete``; ``alloc status``, ``eval
    status`` and ``node status`` of the dev node. The agent's own
    ``/v1/agent/trace`` shows ``place_closed_form_kernel`` called, its
    node carries the card's name as ``gpu.type`` and the device class
    that follows from it, no kernel call finished on a fallback, and the
    agent exits within ``AGENT_STOP_S`` of SIGINT. Returns the times."""
    import re
    import shutil
    import signal
    import tempfile

    from nomad_tpu_torch.api.client import NomadClient
    from nomad_tpu_torch.backend import BUILD_DIR
    from nomad_tpu_torch.client.fingerprint import normalize_device_class

    tmp = tempfile.mkdtemp(prefix="agent-cli-", dir=BUILD_DIR)  # inside the checkout
    env = dict(os.environ, PYTHONUNBUFFERED="1")
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "nomad_tpu_torch.cli", "agent", "-dev",
         "--bind", "127.0.0.1:0", "--data-dir", os.path.join(tmp, "data")],
        cwd=REPO_DIR, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    lines, found, ready = [], {}, threading.Event()

    def pump():  # keeps the agent's pipe drained for its whole life
        for line in proc.stdout:
            lines.append(line)
            for key, pattern in (("addr", r"==> .* running at (\S+)"),
                                 ("node", r"node id: (\S+)")):
                m = re.search(pattern, line)
                if m:
                    found[key] = m.group(1)
            if len(found) == 2:
                ready.set()
        ready.set()

    reader = threading.Thread(target=pump, daemon=True)
    reader.start()
    out = {}
    try:
        ready.wait(AGENT_READY_S)
        assert len(found) == 2, "agent never came up:\n" + "".join(lines[-40:])
        out["ready_s"] = time.perf_counter() - t0
        addr, node_id = found["addr"], found["node"]
        job_file = os.path.join(tmp, "web.hcl")
        with open(job_file, "w") as f:
            f.write(AGENT_JOB_HCL)
        t_run = time.perf_counter()
        run_out, out["job_run_s"] = agent_cli("job", "run", job_file, addr=addr)
        assert "finished: complete" in run_out, run_out
        deadline, statuses = time.perf_counter() + 60.0, []
        while True:
            status, _ = agent_cli("job", "status", "web", addr=addr)
            rows = status.split("\nAllocations\n", 1)[1].strip().splitlines()[1:]
            statuses = [r.split()[-1] for r in rows]
            if statuses == ["complete"] * 3 or time.perf_counter() > deadline:
                break
            time.sleep(0.2)
        assert statuses == ["complete"] * 3, status
        out["job_run_to_complete_s"] = time.perf_counter() - t_run
        c = NomadClient(addr)
        alloc_id = c.jobs.allocations("web")[0]["id"]
        eval_id = c.jobs.evaluations("web")[0]["id"]
        out["cli_s"] = {}
        for cmd in (("alloc", "status", alloc_id), ("eval", "status", eval_id),
                    ("node", "status", node_id)):
            _, out["cli_s"][" ".join(cmd[:2])] = agent_cli(*cmd, addr=addr)
        kernels = c.get("/v1/agent/trace")["kernels"]
        out["agent_kernels"] = kernels
        assert kernels.get("place_closed_form_kernel", {}).get("calls", 0) >= 1, kernels
        node = c.nodes.info(node_id)
        card_name = torch.cuda.get_device_name(0)
        out["gpu_type"], out["device_class"] = node["attributes"].get("gpu.type"), node[
            "device_class"]
        assert out["gpu_type"] == card_name, (out["gpu_type"], card_name)
        assert node["device_class"] == normalize_device_class(card_name), node["device_class"]
        fallbacks = c.agent.metrics()["counters"].get(FALLBACK_CALLS, 0)
        assert fallbacks == 0, fallbacks
        t_stop = time.perf_counter()
        proc.send_signal(signal.SIGINT)
        rc = proc.wait(timeout=AGENT_STOP_S)
        out["stop_s"] = time.perf_counter() - t_stop
        assert rc == 0, (rc, "".join(lines[-40:]))
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        reader.join(timeout=5)
        shutil.rmtree(tmp, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    log("[agent] cli " + json.dumps(out, sort_keys=True))
    return out


def agent_http_path(dev, server_out, n_nodes=SERVER_BENCH["n_nodes"],
                    n_jobs=SERVER_BENCH["n_jobs"], per_job=SERVER_BENCH["per_job"], racks=25):
    """Part (b) of the "agent" path: the same front door at the "server"
    path's size, in process. ``DevAgent(device=dev)`` (one batching
    worker, as the bench's server) and ``HTTPAgent(port=0)``; the bench's
    10,000 nodes seeded straight into the store (setup, not timed); the
    dev node made ineligible through ``POST /v1/node/<id>/eligibility``
    so the recipe's ``exec`` tasks cannot land on this host's client; the
    bench's warmup; then its 100 jobs x 250 registered through the SDK
    (``NomadClient.jobs.register(encode(job))``, one HTTP request a job),
    the evals drained, and every job's allocations read back through
    ``GET /v1/job/<id>/allocations``. Every closed-form and coupled call
    is recorded. Gates: every alloc placed, no over-committed node, the
    API's allocations equal the store's (id → node), no fallback.
    Returns the launch counts, the coupled calls and the summary, with
    the "server" path's allocs/s and eval p50 beside this path's."""
    from nomad_tpu_torch.agent import DevAgent
    from nomad_tpu_torch.api.client import NomadClient
    from nomad_tpu_torch.api.codec import encode
    from nomad_tpu_torch.api.http import HTTPAgent
    from nomad_tpu_torch.device import score as S
    from nomad_tpu_torch.obs import flight_recorder, phase_breakdown
    from nomad_tpu_torch.obs.recorder import trace_latencies
    from nomad_tpu_torch.utils.metrics import global_metrics

    import shutil
    import tempfile

    import bench_torch
    from nomad_tpu_torch.backend import BUILD_DIR

    t_path = time.perf_counter()
    bench_torch.build_kernels(dev)
    data_dir = tempfile.mkdtemp(prefix="agent-http-", dir=BUILD_DIR)  # inside the checkout
    agent = DevAgent(num_workers=1, device=dev, data_dir=data_dir)
    http = None
    try:
        agent.start()
        http = HTTPAgent(agent.server, agent.client, port=0)
        http.start()
        c = NomadClient(http.address)
        store, server = agent.server.store, agent.server
        t0 = time.perf_counter()
        for i in range(n_nodes):  # straight into the store, as the bench does
            store.upsert_node(store.latest_index + 1, bench_torch.bench_node(i, racks))
        dev_node = agent.client.node.id
        c.nodes.eligibility(dev_node, False)
        assert store.node_by_id(dev_node).scheduling_eligibility == "ineligible"
        assert bench_torch.warm_up(server, per_job)
        setup_s = time.perf_counter() - t0
        payloads = [encode(bench_torch.bench_job(j, per_job)) for j in range(n_jobs)]
        global_metrics.reset()
        flight_recorder.clear()

        zero_counters()
        register_s = []
        with contextlib.ExitStack() as stack:
            stack.enter_context(shared_recording("agent", score_matrix=False))
            coupled = {name: stack.enter_context(recording(S, name)) for name in COUPLED}
            t0 = time.perf_counter()
            for payload in payloads:
                t_req = time.perf_counter()
                c.jobs.register(payload)
                register_s.append(time.perf_counter() - t_req)
            drained = server.wait_for_evals(timeout=600)
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
        launches = counters()

        t0 = time.perf_counter()
        api = {}
        for j in range(n_jobs):
            for a in c.jobs.allocations(f"bench-{j}"):
                api[a["id"]] = a["node_id"]
        readback_s = time.perf_counter() - t0
        want = {
            a.id: a.node_id for a in store.allocs() if a.job_id.startswith("bench-")
        }
        placed = sum(
            1 for a in store.allocs() if a.job_id.startswith("bench-") and not a.terminal_status()
        )
        overcommit = committed_overcommit(store)
        traces = flight_recorder.traces()
        eval_s = [trace_latencies(t)[0] for t in traces]
        counters_now = global_metrics.snapshot()["counters"]
        summary = {
            "config": f"{n_nodes} nodes, {n_jobs} jobs x {per_job} allocs through the SDK, "
            f"spread+affinity, mixed service/batch",
            "setup_s": setup_s,
            "drained": drained,
            "placed": placed,
            "total": n_jobs * per_job,
            "committed_overcommit": overcommit,
            "api_equals_store": api == want,
            "elapsed_s": elapsed,
            "allocs_per_sec": placed / elapsed,
            "eval_latency_ms": {
                "evals": len(eval_s),
                "p50": bench_torch.percentile_ms(eval_s, 50),
                "p99": bench_torch.percentile_ms(eval_s, 99),
            },
            "register_ms": {
                "requests": len(register_s),
                "p50": bench_torch.percentile_ms(register_s, 50),
                "p99": bench_torch.percentile_ms(register_s, 99),
            },
            "readback_s": readback_s,
            "readback_allocs": len(api),
            "fallback_calls": int(counters_now.get(FALLBACK_CALLS, 0)),
            "phase_breakdown_ms": phase_breakdown(traces),
            "server_path": {
                "allocs_per_sec": server_out["allocs_per_sec"],
                "eval_p50_ms": server_out["eval_latency_ms"]["p50"],
                "eval_p99_ms": server_out["eval_latency_ms"]["p99"],
            },
        }
    finally:
        try:
            if http is not None:
                http.stop()
        finally:
            agent.shutdown()
            shutil.rmtree(data_dir, ignore_errors=True)
    summary["path_seconds"] = time.perf_counter() - t_path
    log(
        f"[agent] http {summary['config']}: allocs_per_sec={summary['allocs_per_sec']!r} "
        f"(server path {server_out['allocs_per_sec']!r}) eval p50_ms="
        f"{summary['eval_latency_ms']['p50']!r} p99_ms={summary['eval_latency_ms']['p99']!r} "
        f"(server path p50_ms {server_out['eval_latency_ms']['p50']!r}); register request "
        f"p50_ms={summary['register_ms']['p50']!r} p99_ms={summary['register_ms']['p99']!r}; "
        f"read-back of {len(api)} allocs {readback_s!r} s; placed {placed}/"
        f"{summary['total']}, over-committed nodes {overcommit}; launches {launches}"
    )
    log("[agent] phase_breakdown_ms " + json.dumps(summary["phase_breakdown_ms"],
                                                   sort_keys=True))
    assert drained, "the agent's server did not drain"
    assert placed == n_jobs * per_job, (placed, n_jobs * per_job)
    assert overcommit == 0, "a node is over-committed in the store"
    assert api == want, "the API's allocations differ from the store's"
    assert summary["fallback_calls"] == 0, summary["fallback_calls"]
    for name, calls in coupled.items():
        assert len(calls) == launches[name], (name, len(calls), launches[name])
    assert launches["place_spread_opv"] > 0
    off = (*PREEMPT_COUNTS, *PLUGIN, "migrate_plan", "score_matrix")
    assert all(launches[n] == 0 for n in off), launches
    return launches, coupled, summary


# the "cluster" path: three server processes of one raft group on the card
CLUSTER_IDS = ("s1", "s2", "s3")
CLUSTER_RACKS = 25
# a member's raft: hashicorp/raft's own defaults (1 s heartbeat and
# election timeouts), so that a leader's pass of host Python cannot
# stall its heartbeats past a follower's timeout
CLUSTER_RAFT = {
    "election_timeout_min": 1.0, "election_timeout_max": 2.0,
    "heartbeat_interval": 0.1, "rpc_timeout": 10.0,
}
# no client heartbeats a node here: a TTL that outlives the run, so that
# a new leader's heartbeat timers (seeded from its store) mark none down
CLUSTER_HEARTBEAT_TTL = 3600.0
CLUSTER_REGISTER_THREADS = 8  # concurrent node registrations
CLUSTER_READY_S = 180.0  # a member imports torch and opens a CUDA context
CLUSTER_ELECT_S = 60.0
CLUSTER_PLACE_S = 600.0
CLUSTER_STOP_S = 30.0
CLUSTER_CALL_S = 600.0  # an RPC to a member (a replay runs inside it)


def cluster_member(argv) -> int:
    """One member of the "cluster" path, in a process of its own:
    ``python3 chip_smoke.py --cluster-member <id> --peers <json>
    --data-dir <dir> [--device cuda]``. An ``RPCServer`` on its peer
    address and a ``ClusterServer(server_config=ServerConfig(device,
    num_workers=1))`` on it, its kernel wrappers under the script's
    recording for the process's life; beside the cluster's RPC surface
    it serves ``Smoke.status`` (raft state, leader services, launches,
    the device cache's counters, fallback calls, eval latency),
    ``Smoke.view`` (its store: placements by (job, node), latest index,
    over-committed nodes, queues), ``Smoke.drain`` (the server's
    ``wait_for_evals``), ``Smoke.zero``, ``Smoke.replay``
    (ends the recording and holds every recorded call against its plain
    version, as the in-process paths do) and ``Smoke.stop``. No fallback:
    a member that finds no CUDA raises."""
    import argparse
    import hashlib

    from nomad_tpu_torch.device import score as S
    from nomad_tpu_torch.obs import flight_recorder
    from nomad_tpu_torch.obs.recorder import trace_latencies
    from nomad_tpu_torch.rpc import RPCServer
    from nomad_tpu_torch.server.cluster import ClusterServer
    from nomad_tpu_torch.server.server import ServerConfig
    from nomad_tpu_torch.utils.metrics import global_metrics

    import bench_torch

    p = argparse.ArgumentParser(prog="chip_smoke.py --cluster-member")
    p.add_argument("--cluster-member", required=True)
    p.add_argument("--peers", required=True)
    p.add_argument("--data-dir", required=True)
    p.add_argument("--device", default="cuda")
    a = p.parse_args(argv)
    me, peers = a.cluster_member, json.loads(a.peers)
    rpc = RPCServer(port=int(peers[me].rsplit(":", 1)[1]))
    deadline = time.monotonic() + 30  # a restart may find the port in TIME_WAIT
    while True:
        try:
            rpc.start()
            break
        except OSError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.2)
    path = f"cluster-{me}"
    recordings = contextlib.ExitStack()
    recordings.enter_context(shared_recording(path, score_matrix=False))
    coupled = {name: recordings.enter_context(recording(S, name)) for name in COUPLED}
    member = ClusterServer(
        me, peers, rpc, data_dir=a.data_dir,
        server_config=ServerConfig(
            device=a.device, num_workers=1, heartbeat_ttl=CLUSTER_HEARTBEAT_TTL,
        ),
        **CLUSTER_RAFT,
    )
    stop = threading.Event()

    def status(_args):
        eval_s = [trace_latencies(t)[0] for t in flight_recorder.traces()]
        return {
            "id": me, "pid": os.getpid(), "raft": member.raft.stats(),
            "services": bool(member.server._leader),
            "launches": counters(),
            "device_cache": cache_counters(member.server.device_cache),
            "fallback_calls": int(
                global_metrics.snapshot()["counters"].get(FALLBACK_CALLS, 0)
            ),
            "evals": len(eval_s),
            "eval_p50_ms": bench_torch.percentile_ms(eval_s, 50) if eval_s else None,
            "eval_p99_ms": bench_torch.percentile_ms(eval_s, 99) if eval_s else None,
        }

    def view(_args):
        # a frozen view: the applier writes the live store meanwhile
        store = member.server.store.snapshot()
        live = collections.Counter(
            (al.job_id, al.node_id) for al in store.allocs() if not al.terminal_status()
        )
        names = sorted(al.name for al in store.allocs() if not al.terminal_status())
        rows = sorted(f"{j} {n} {c}" for (j, n), c in live.items())
        depths = member.server.eval_broker.queue_depths()
        return {
            "latest_index": store.index,
            "nodes": sum(1 for _ in store.nodes()),
            "placed": sum(live.values()),
            "placed_by_job": dict(collections.Counter(j for j, _n in live.elements())),
            "digest": hashlib.sha256("\n".join(rows + names).encode()).hexdigest(),
            "overcommitted": committed_overcommit(store),
            "queued": depths["ready"] + depths["unacked"] + depths["delayed"]
            + depths.get("deferred", 0),
            "failed_evals": sum(1 for e in store.evals() if e.status == "failed"),
        }

    def drain(args):
        return member.server.wait_for_evals(timeout=args["timeout"])

    def zero(_args):
        zero_counters()
        return counters()

    def replay(_args):
        # the recording ends here: what the process launched is what
        # it recorded, and the replays below are not counted as its own
        launches = counters()
        recordings.close()
        recorded = {
            "place_closed_form": SHARED_CALLS.get(path, {}).get("place_closed_form", []),
            **coupled,
        }
        out = {"launches": launches, "recorded": {k: len(v) for k, v in recorded.items()}}
        # a kernel that launched nothing (a follower's, or the CPU's plain
        # versions) has nothing to hold against plain
        cf = recorded["place_closed_form"]
        if launches["place_closed_form"]:
            r = replay_shared("place_closed_form", cf, path)
            out["place_closed_form"] = {
                k: r[k] for k in ("calls", "path_ms", "max_abs_err", "choice_mismatches",
                                  "blocks_per_lane", "shapes")
            }
        for name, calls in coupled.items():
            if launches[name]:
                r = replay_coupled(name, calls)
                out[name] = {
                    "calls": len(calls),
                    **{k: r[k] for k in ("path_ms", "max_abs_err", "choice_mismatches",
                                         "ms", "shape")},
                }
        return out

    def stop_(_args):
        stop.set()
        return True

    for name, fn in (("status", status), ("view", view), ("drain", drain), ("zero", zero),
                     ("replay", replay), ("stop", stop_)):
        rpc.register(f"Smoke.{name}", fn)
    member.start()
    log(f"[cluster {me}] pid {os.getpid()} serving at {rpc.address} on {a.device}")
    stop.wait()
    member.shutdown()
    rpc.stop()
    log(f"[cluster {me}] stopped")
    return 0


def cache_counters(cache) -> dict:
    """What a member's ``DeviceStateCache`` built and uploaded: full
    flattens (a cold build), journal refreshes, hits, whether capacity is
    resident on the card, and the score state's uploads."""
    counts = cache.device_counters()
    return {
        "full_flattens": cache.full_flattens,
        "incremental_refreshes": cache.incremental_refreshes,
        "hits": cache.hits,
        "capacity_resident": cache._dev_capacity is not None,
        "score_full_rebuilds": counts["score_full_rebuilds"],
        "score_patch_uploads": counts["score_patch_uploads"],
    }


class ClusterRun:
    """The member processes of the "cluster" path and the script's RPC
    clients to them."""

    def __init__(self, dev, base):
        import socket

        from nomad_tpu_torch.rpc import RPCClient

        self.dev, self.base, self.RPCClient = dev, base, RPCClient
        ports = []
        socks = []
        for _ in CLUSTER_IDS:  # three free ports, held until all are picked
            s = socket.socket()
            s.bind(("127.0.0.1", 0))
            socks.append(s)
            ports.append(s.getsockname()[1])
        for s in socks:
            s.close()
        self.peers = {m: f"127.0.0.1:{p}" for m, p in zip(CLUSTER_IDS, ports)}
        self.procs, self.clients, self.logs = {}, {}, {}

    def spawn(self, mid):
        self.logs[mid] = open(os.path.join(self.base, f"{mid}.log"), "ab")
        self.procs[mid] = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--cluster-member", mid,
             "--peers", json.dumps(self.peers),
             "--data-dir", os.path.join(self.base, mid), "--device", self.dev.type],
            cwd=REPO_DIR, stdout=self.logs[mid], stderr=subprocess.STDOUT,
        )

    def call(self, mid, method, args=None, timeout=CLUSTER_CALL_S):
        c = self.clients.get(mid)
        if c is None:
            c = self.clients[mid] = self.RPCClient(
                self.peers[mid], timeout=timeout, max_attempts=1
            )
        return c.call(method, args, timeout=timeout)

    def drop_client(self, mid):
        c = self.clients.pop(mid, None)
        if c is not None:
            c.close()

    def wait_ready(self, mid, deadline_s=CLUSTER_READY_S):
        deadline = time.monotonic() + deadline_s
        while True:
            assert self.procs[mid].poll() is None, (mid, "exited", self.tail(mid))
            try:
                return self.call(mid, "Smoke.status", timeout=5.0)
            except Exception:  # noqa: BLE001 — not serving yet
                self.drop_client(mid)
                assert time.monotonic() < deadline, (mid, "not ready", self.tail(mid))
                time.sleep(0.25)

    def statuses(self, mids):
        return {m: self.call(m, "Smoke.status") for m in mids}

    def leader(self, mids, deadline_s=CLUSTER_ELECT_S):
        """The one member of ``mids`` that leads with its services up."""
        deadline = time.monotonic() + deadline_s
        while True:
            st = self.statuses(mids)
            leaders = [m for m, s in st.items() if s["raft"]["state"] == "Leader"]
            if len(leaders) == 1 and st[leaders[0]]["services"]:
                return leaders[0], st
            assert time.monotonic() < deadline, ("no leader", st)
            time.sleep(0.05)

    def tail(self, mid, n=4000):
        try:
            with open(os.path.join(self.base, f"{mid}.log"), "rb") as f:
                return f.read()[-n:].decode(errors="replace")
        except OSError:
            return ""

    def stop_all(self):
        """Every member still running stopped by ``Smoke.stop``, killed
        past ``CLUSTER_STOP_S``; returns their exit codes."""
        for mid, proc in self.procs.items():
            if proc.poll() is None:
                try:
                    self.call(mid, "Smoke.stop", timeout=5.0)
                except Exception:  # noqa: BLE001 — killed below
                    pass
        codes = {}
        for mid, proc in self.procs.items():
            try:
                codes[mid] = proc.wait(timeout=CLUSTER_STOP_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                codes[mid] = ("killed", proc.wait())
        for mid in list(self.clients):
            self.drop_client(mid)
        for f in self.logs.values():
            f.close()
        return codes


def cluster_path(dev, server_out, n_nodes=SERVER_BENCH["n_nodes"],
                 n_jobs=SERVER_BENCH["n_jobs"], per_job=SERVER_BENCH["per_job"],
                 racks=CLUSTER_RACKS):
    """The "cluster" path: three server processes (``cluster_member``), a
    raft group on one card. The "server" path's fleet and jobs
    (``bench_torch.bench_node`` / ``bench_job``): its 10,000 nodes registered over RPC
    through the three members (a follower forwards to the leader; one
    raft entry a node, a WAL sync at the leader), its 100 jobs x 250
    registered through a follower (each forwarded), placed by the leader
    on the card and replicated; the leader's recorded calls replayed in
    its process; the leader killed (SIGKILL); a survivor elected, its
    services up; two further jobs (the recipe's, and the same without its
    spread, which the closed form places) registered through the
    remaining follower and placed by the new leader on the card from a
    cold cache on the replicated store; its calls replayed; the killed
    member restarted on its data dir and caught up. Gates: every member
    that led holds one kernel call or more, all identical to plain;
    every alloc placed; no node over-committed in any store (the dead
    leader's allocs counted); the three stores' placements by (job,
    node) and alloc names, and their latest index, equal after the
    catch-up; no member launched a kernel while it followed; no fallback
    call in any process; every member stopped. Returns the launch counts
    (the two leaders' replays' counts, summed), the replays and the
    summary."""
    import shutil
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    import bench_torch
    from nomad_tpu_torch.backend import BUILD_DIR

    t_path = time.perf_counter()
    base = tempfile.mkdtemp(prefix="cluster-", dir=BUILD_DIR)  # inside the checkout
    run = ClusterRun(dev, base)
    phases, status_log = {}, {}
    try:
        t0 = time.perf_counter()
        for mid in CLUSTER_IDS:
            run.spawn(mid)
        for mid in CLUSTER_IDS:
            run.wait_ready(mid)
        phases["start_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        first, _ = run.leader(CLUSTER_IDS)
        phases["election_s"] = time.perf_counter() - t0
        followers = [m for m in CLUSTER_IDS if m != first]

        # the nodes over RPC through every member, a raft entry each
        nodes = [bench_torch.bench_node(i, racks) for i in range(n_nodes)]
        t0 = time.perf_counter()
        with ThreadPoolExecutor(CLUSTER_REGISTER_THREADS) as pool:
            list(pool.map(
                lambda i: run.call(CLUSTER_IDS[i % 3], "Nomad.register_node",
                                   {"node": nodes[i]}),
                range(n_nodes),
            ))
        phases["register_nodes_s"] = time.perf_counter() - t0
        phases["nodes_per_s"] = n_nodes / phases["register_nodes_s"]
        assert run.call(first, "Smoke.view")["nodes"] == n_nodes
        del nodes

        # the jobs through a follower, placed by the leader on the card
        via = followers[0]
        for mid in CLUSTER_IDS:
            assert not any(run.call(mid, "Smoke.zero").values())
        t0 = time.perf_counter()
        for j in range(n_jobs):
            run.call(via, "Nomad.register_job", {"job": bench_torch.bench_job(j, per_job)})
        phases["register_jobs_s"] = time.perf_counter() - t0
        total = n_jobs * per_job
        assert run.call(first, "Smoke.drain", {"timeout": CLUSTER_PLACE_S}), "no drain"
        phases["placement_s"] = time.perf_counter() - t0
        v = run.call(first, "Smoke.view")
        phases["allocs_per_s"] = v["placed"] / phases["placement_s"]
        assert v["placed"] == total, (v["placed"], total)
        t0 = time.perf_counter()
        want = run.call(first, "Smoke.view")
        deadline = time.monotonic() + CLUSTER_PLACE_S
        while not all(
            run.call(m, "Smoke.view")["digest"] == want["digest"] for m in followers
        ):
            assert time.monotonic() < deadline, "followers did not converge"
            time.sleep(0.25)
        phases["replication_lag_s"] = time.perf_counter() - t0
        status_log["before_failover"] = st = run.statuses(CLUSTER_IDS)
        for m in followers:  # no follower launched a kernel or built its cache
            assert not any(st[m]["launches"].values()), (m, st[m]["launches"])
            assert st[m]["device_cache"]["full_flattens"] == 0, (m, st[m]["device_cache"])
        replays = {first: run.call(first, "Smoke.replay")}

        # failover: the leader killed once its replay has returned
        t_kill = time.perf_counter()
        run.procs[first].kill()
        run.procs[first].wait()
        run.drop_client(first)
        second, st2 = run.leader(followers)
        phases["failover_s"] = time.perf_counter() - t_kill
        other = next(m for m in followers if m != second)
        assert not any(st2[other]["launches"].values()), st2[other]
        after = [bench_torch.bench_job(n_jobs, per_job), bench_torch.bench_job(n_jobs + 1, per_job)]
        after[1].spreads = []  # the closed form's: no coupled group
        t0 = time.perf_counter()
        for job in after:
            run.call(other, "Nomad.register_job", {"job": job})
        total += len(after) * per_job
        assert run.call(second, "Smoke.drain", {"timeout": CLUSTER_PLACE_S}), "no drain"
        phases["post_failover_placement_s"] = time.perf_counter() - t0
        v = run.call(second, "Smoke.view")
        assert v["placed"] == total, (v["placed"], total)
        status_log["after_failover"] = run.statuses(followers)
        replays[second] = run.call(second, "Smoke.replay")

        # the killed member back on its data dir, caught up
        t0 = time.perf_counter()
        run.spawn(first)
        run.wait_ready(first)
        want = run.call(second, "Smoke.view")
        deadline = time.monotonic() + CLUSTER_PLACE_S
        while True:
            views = {m: run.call(m, "Smoke.view") for m in CLUSTER_IDS}
            if all(
                views[m]["digest"] == want["digest"]
                and views[m]["latest_index"] == want["latest_index"] for m in CLUSTER_IDS
            ):
                break
            assert time.monotonic() < deadline, ("catch-up", views)
            time.sleep(0.25)
            want = run.call(second, "Smoke.view")
        phases["catch_up_s"] = time.perf_counter() - t0
        status_log["final"] = final = run.statuses(CLUSTER_IDS)
    except BaseException:
        for mid in run.procs:
            log(f"[cluster {mid}] log tail:\n{run.tail(mid)}")
        raise
    finally:
        codes = run.stop_all()
        shutil.rmtree(base, ignore_errors=True)
    phases["path_s"] = time.perf_counter() - t_path
    leaders = (first, second)
    launches = {
        name: sum(replays[m]["launches"][name] for m in leaders) for name in counters()
    }
    summary = {
        "config": f"3 server processes, {n_nodes} nodes over RPC, {n_jobs} jobs x {per_job} "
        f"through a follower, then 2 x {per_job} after failover",
        "raft": CLUSTER_RAFT,
        "leaders": list(leaders),
        "phases": phases,
        "server_path_allocs_per_s": server_out["allocs_per_sec"],
        "eval_ms": {m: {k: status_log["before_failover" if m == first else "final"][m][k]
                        for k in ("evals", "eval_p50_ms", "eval_p99_ms")} for m in leaders},
        "views": {m: {k: views[m][k] for k in ("latest_index", "placed", "overcommitted",
                                               "failed_evals", "nodes")}
                  for m in CLUSTER_IDS},
        "launches_by_member": {
            "before_failover": {m: s["launches"] for m, s in status_log["before_failover"].items()},
            "after_failover": {m: s["launches"] for m, s in status_log["after_failover"].items()},
            "restarted": final[first]["launches"],
        },
        "device_cache": {
            phase: {m: s["device_cache"] for m, s in st_.items()}
            for phase, st_ in status_log.items()
        },
        "fallback_calls": {
            **{f"{m} (first run)": s["fallback_calls"]
               for m, s in status_log["before_failover"].items()},
            **{m: s["fallback_calls"] for m, s in final.items()},
        },
        "replays": replays,
        "exit_codes": {m: c if isinstance(c, int) else str(c) for m, c in codes.items()},
    }
    log(
        f"[cluster] {summary['config']}: start {phases['start_s']!r} s, election "
        f"{phases['election_s']!r} s, nodes {phases['register_nodes_s']!r} s "
        f"({phases['nodes_per_s']!r} nodes/s), jobs registered {phases['register_jobs_s']!r} s, "
        f"placement {phases['placement_s']!r} s ({phases['allocs_per_s']!r} allocs/s; the "
        f"server path's {server_out['allocs_per_sec']!r}, context only), eval p50/p99 "
        f"{summary['eval_ms'][first]['eval_p50_ms']!r} / {summary['eval_ms'][first]['eval_p99_ms']!r}"
        f" ms, replication lag {phases['replication_lag_s']!r} s, failover (kill to the new "
        f"leader's services) {phases['failover_s']!r} s, first placement after failover "
        f"{phases['post_failover_placement_s']!r} s, catch-up {phases['catch_up_s']!r} s; "
        f"leaders {first} then {second}"
    )
    log("[cluster] " + json.dumps(summary, sort_keys=True))
    cluster_gates(summary, leaders, total)
    return launches, replays, summary


def cluster_gates(summary, leaders, total):
    """The "cluster" path's gates on what its members reported."""
    for m in leaders:
        r = summary["replays"][m]
        # every launch recorded, every recorded call replayed
        assert r["recorded"] == {k: r["launches"][k] for k in r["recorded"]}, (m, r)
        kernels = [k for k in r if k not in ("launches", "recorded")]
        assert kernels and all(r[k]["calls"] >= 1 for k in kernels), (m, r)
        assert all(r[k]["choice_mismatches"] == 0 for k in kernels), (m, r)
    views = summary["views"]
    assert all(v["placed"] == total for v in views.values()), views
    assert all(v["overcommitted"] == 0 for v in views.values()), views
    assert len({v["latest_index"] for v in views.values()}) == 1, views
    restarted = summary["launches_by_member"]["restarted"]
    assert not any(restarted.values()), restarted
    assert not any(summary["fallback_calls"].values()), summary["fallback_calls"]
    # the killed leader's process was replaced by its restart: every
    # member that ran to the end stopped on its own
    assert all(c == 0 for c in summary["exit_codes"].values()), summary["exit_codes"]


# the "plugins" path: the client's out-of-process plugins on the card
PLUGINS_GPU_EVERY = 4  # every 4th fleet node carries a DGX-class group
PLUGINS_GPU_NAME = "a100-sxm4-80gb"
PLUGINS_GPU_INSTANCES = 8
PLUGINS_GPU_MEMORY_MB = 81920
PLUGINS_SERVICE = (16, 100, 1)  # jobs, allocs a job, instances an alloc
PLUGINS_BATCH = (4, 50, 8)  # a whole host an alloc
PLUGINS_WAIT_S = 120.0
PLUGINS_SLEEP_S = 5  # the reattach task's run


def compute_apps() -> dict:
    """pid → used MiB of every process ``nvidia-smi`` lists on the card."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout
    apps = {}
    for line in out.strip().splitlines():
        pid, _, mem = line.partition(",")
        if pid.strip().isdigit():
            apps[int(pid)] = mem.strip()
    return apps


@contextlib.contextmanager
def plugin_timings():
    """While the block starts an agent's client, times each plugin it
    starts (a fresh process through the package's launcher): seconds to
    its handshake line and to its first answer (a driver's fingerprint,
    the device table, a CSI probe), by "<kind> <name>". Around the
    device table's read also the card's free memory
    (``torch.cuda.mem_get_info``, device-wide: nothing else touches the
    card meanwhile), so that a context the plugin's process opens shows
    as ``card_mib``."""
    from nomad_tpu_torch.client import csi_plugin, device_plugin, plugin, stdio_plugin

    out = {}
    kinds = {device_plugin.DevicePluginClient: "device", csi_plugin.CSIPluginClient: "csi"}

    def timed(cls, name, key, card=False):
        real = getattr(cls, name)

        def call(self, *args, **kwargs):
            what = f"{kinds.get(type(self), 'driver')} {self.name}"
            if card:
                torch.cuda.synchronize()
                free0 = torch.cuda.mem_get_info()[0]
            t0 = time.perf_counter()
            try:
                return real(self, *args, **kwargs)
            finally:
                entry = out.setdefault(what, {})
                entry.setdefault(key, time.perf_counter() - t0)
                if card:
                    entry.setdefault("card_mib", (free0 - torch.cuda.mem_get_info()[0]) / 2**20)

        return cls, name, real, call

    patches = [
        timed(stdio_plugin.StdioPluginClient, "_ensure", "handshake_s"),
        timed(plugin.PluginDriverClient, "_ensure_plugin", "handshake_s"),
        timed(plugin.PluginDriverClient, "fingerprint", "fingerprint_s"),
        timed(device_plugin.DevicePluginClient, "fingerprint", "fingerprint_s", card=True),
        timed(csi_plugin.CSIPluginClient, "probe", "probe_s"),
    ]
    for cls, name, _, call in patches:
        setattr(cls, name, call)
    try:
        yield out
    finally:
        for cls, name, real, _ in patches:
            setattr(cls, name, real)


@contextlib.contextmanager
def reaping_orphans(pids):
    """While the block runs, this process adopts the orphans of its
    descendants (``PR_SET_CHILD_SUBREAPER`` on itself) and reaps each pid
    of ``pids`` (a list the block appends to) as it exits, so that a task
    whose driver plugin was killed does not linger as a zombie, alive to
    ``kill(pid, 0)``, wherever this process runs. Yields the exit codes
    it reaped, by pid."""
    libc = ctypes.CDLL(None, use_errno=True)
    pr_set_child_subreaper = 36
    assert libc.prctl(pr_set_child_subreaper, 1, 0, 0, 0) == 0, ctypes.get_errno()
    codes, stop = {}, threading.Event()

    def reap():
        while not stop.wait(0.05):
            for pid in list(pids):
                if pid in codes:
                    continue
                try:
                    got, status = os.waitpid(pid, os.WNOHANG)
                except ChildProcessError:  # not ours (yet): still its parent's
                    continue
                if got == pid:
                    codes[pid] = os.waitstatus_to_exitcode(status)

    thread = threading.Thread(target=reap, daemon=True)
    thread.start()
    try:
        yield codes
    finally:
        stop.set()
        thread.join(timeout=5)
        libc.prctl(pr_set_child_subreaper, 0, 0, 0, 0)


def gpu_fleet_node(i):
    """``bench_torch.bench_node(i)``; every ``PLUGINS_GPU_EVERY``-th also
    carries an ``nvidia/gpu/a100-sxm4-80gb`` group of 8 healthy instances,
    as a DGX-class host does."""
    import bench_torch
    from nomad_tpu_torch.structs.resources import NodeDeviceInstance, NodeDeviceResource

    node = bench_torch.bench_node(i)
    if i % PLUGINS_GPU_EVERY == 0:
        node.node_resources.devices = [NodeDeviceResource(
            vendor="nvidia", type="gpu", name=PLUGINS_GPU_NAME,
            instances=[NodeDeviceInstance(id=f"{node.id[:8]}-gpu-{k}")
                       for k in range(PLUGINS_GPU_INSTANCES)],
            attributes={"memory_mb": PLUGINS_GPU_MEMORY_MB},
        )]
        node.compute_class()
    return node


def gpu_jobs():
    """16 service jobs x 100 allocs of one ``nvidia/gpu`` instance (the odd
    ones with a device affinity on the group's ``memory_mb``), then 4
    batch jobs x 50 allocs of 8 (a whole host each)."""
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.structs import Affinity
    from nomad_tpu_torch.structs.resources import RequestedDevice

    jobs = []
    for kind, (n_jobs, count, per_alloc) in (("svc", PLUGINS_SERVICE), ("batch", PLUGINS_BATCH)):
        for j in range(n_jobs):
            job = mock.job() if kind == "svc" else mock.batch_job()
            job.id = f"gpu-{kind}-{j}"
            tg = job.task_groups[0]
            tg.count = count
            ask = RequestedDevice(name="nvidia/gpu", count=per_alloc)
            if kind == "svc" and j % 2:
                ask.affinities = [Affinity(l_target="${device.attr.memory_mb}",
                                           r_target="40000", operand=">=", weight=50)]
            tg.tasks[0].resources.devices = [ask]
            jobs.append(job)
    return jobs


def wait_alloc(store, job_id, status="complete", timeout=PLUGINS_WAIT_S):
    deadline = time.perf_counter() + timeout
    while time.perf_counter() < deadline:
        allocs = store.allocs_by_job("default", job_id)
        if allocs and all(a.client_status == status for a in allocs):
            return allocs
        time.sleep(0.05)
    raise AssertionError(
        f"{job_id}: {[(a.client_status, a.node_id) for a in store.allocs_by_job('default', job_id)]}"
    )


def task_output(agent, alloc, task):
    runner = agent.client.runners[alloc.id]
    with open(os.path.join(runner.alloc_dir, task, f"{task}.stdout")) as f:
        return f.read()


PROBE_SCRIPT = (
    "import os, torch; print('CUDA_VISIBLE_DEVICES=' + os.environ['CUDA_VISIBLE_DEVICES']); "
    "print('name=' + torch.cuda.get_device_name(0))"
)


def plugins_path(dev):
    """The "plugins" path: the client's out-of-process plugins on the
    card, in one ``DevAgent(device=dev, driver_mode="plugin",
    device_plugins=["torch"], csi_plugins=["hostpath"])`` (the hostpath
    volumes under the checkout's ``build/``). Each plugin's handshake and
    first answer timed as the agent starts it, with the card memory the
    ``torch`` plugin's process takes (``plugin_timings``). Then, in order: (1) the dev node advertises one
    ``nvidia/gpu/<card name>`` group of ``torch.cuda.device_count()``
    instances and ``device.torch``; (2) a batch job of one ``raw_exec``
    task asking ``device "nvidia/gpu/<card name>"`` runs through the
    plugin driver: its alloc holds ``cuda-<k>``, and the task (``python
    -c``) sees ``CUDA_VISIBLE_DEVICES=<k>`` and the card's name; (3) a
    ``sleep 5`` task whose driver plugin is SIGKILLed while it runs: it
    survives, the plugin respawns and recovers it, and it ends with exit
    code 0; (4) two batch allocs in turn on one hostpath CSI volume, the
    first writes a file and the second reads it back; the client's GC
    tears both down and each volume is unpublished; (5) the dev node made
    ineligible, ``bench_torch``'s 10,000 nodes seeded, every 4th with an
    ``nvidia/gpu/a100-sxm4-80gb`` group of 8 instances, and 16 service
    jobs x 100 allocs of one instance (half with a device affinity) and 4
    batch jobs x 50 of 8 registered and drained: every alloc placed, no
    instance twice, every alloc's ids its node's, no node over-committed,
    none on a node without the group. Every closed-form call is recorded
    (``SHARED_CALLS["plugins"]``), and no call finishes on a fallback.
    Returns the launch counts and the summary."""
    import shutil
    import tempfile

    import bench_torch
    from nomad_tpu_torch.agent import DevAgent
    from nomad_tpu_torch.backend import BUILD_DIR
    from nomad_tpu_torch.device import flatten
    from nomad_tpu_torch.obs import flight_recorder, phase_breakdown
    from nomad_tpu_torch.obs.recorder import trace_latencies
    from nomad_tpu_torch.server.fsm import MsgType
    from nomad_tpu_torch.structs import Task
    from nomad_tpu_torch.structs.resources import RequestedDevice
    from nomad_tpu_torch.structs.volumes import (
        ACCESS_MODE_MULTI_NODE_MULTI_WRITER,
        CSIVolume,
        VolumeRequest,
    )
    from nomad_tpu_torch import mock
    from nomad_tpu_torch.utils.metrics import global_metrics

    t_path = time.perf_counter()
    bench_torch.build_kernels(dev)
    summary = {}
    base = tempfile.mkdtemp(prefix="plugins-", dir=BUILD_DIR)  # inside the checkout
    csi_root = os.path.join(base, "csi")
    old_root = os.environ.get("NOMAD_CSI_HOSTPATH_ROOT")
    os.environ["NOMAD_CSI_HOSTPATH_ROOT"] = csi_root
    card = torch.cuda.get_device_name(0)
    slug = card.replace(" ", "-").lower()
    n_cards = torch.cuda.device_count()
    global_metrics.reset()
    zero_counters()
    agent = None
    cap_s = []
    try:
        with contextlib.ExitStack() as stack:
            stack.enter_context(shared_recording("plugins", score_matrix=False))
            t0 = time.perf_counter()
            with plugin_timings() as summary["plugins"]:
                agent = DevAgent(num_workers=1, device=dev, data_dir=os.path.join(base, "agent"),
                                 driver_mode="plugin", device_plugins=["torch"],
                                 csi_plugins=["hostpath"])
            agent.start()
            summary["agent_start_s"] = time.perf_counter() - t0
            server, store, client = agent.server, agent.server.store, agent.client

            # (1) the dev node carries the card
            node = store.node_by_id(client.node.id)
            groups = [(d.vendor, d.type, d.name, [i.id for i in d.instances if i.healthy])
                      for d in node.node_resources.devices]
            assert groups == [("nvidia", "gpu", slug, [f"cuda-{k}" for k in range(n_cards)])], (
                groups)
            assert node.attributes.get("device.torch") == str(n_cards), node.attributes
            assert client.device_group_owner == {("nvidia", "gpu", slug): "torch"}
            torch_pid = client.device_plugins["torch"]._proc.pid
            apps = compute_apps()
            summary["dev_node"] = {"groups": groups, "torch_plugin_pid": torch_pid,
                                   "torch_plugin_in_nvidia_smi": apps.get(torch_pid, "none"),
                                   "compute_apps": apps}

            # (2) the probe job through the plugin driver, on the card
            job = mock.batch_job()
            job.id = "gpu-probe"
            tg = job.task_groups[0]
            tg.count = 1
            tg.tasks[0] = Task(name="probe", driver="raw_exec", config={
                "command": sys.executable, "args": ["-c", PROBE_SCRIPT]})
            tg.tasks[0].resources.devices = [RequestedDevice(name=f"nvidia/gpu/{slug}", count=1)]
            t0 = time.perf_counter()
            server.register_job(job)
            (alloc,) = wait_alloc(store, job.id)
            probe_s = time.perf_counter() - t0
            (ad,) = alloc.allocated_devices
            assert ad.id() == f"nvidia/gpu/{slug}" and len(ad.device_ids) == 1, ad
            ordinal = ad.device_ids[0].rsplit("-", 1)[-1]
            assert ad.device_ids == [f"cuda-{ordinal}"], ad
            seen = task_output(agent, alloc, "probe").strip().splitlines()
            assert seen == [f"CUDA_VISIBLE_DEVICES={ordinal}", f"name={card}"], seen
            summary["probe"] = {"register_to_complete_s": probe_s, "device_ids": ad.device_ids,
                                "task_saw": seen}

            # (3) a task outlives its driver plugin's SIGKILL
            job = mock.batch_job()
            job.id = "reattach"
            tg = job.task_groups[0]
            tg.count = 1
            tg.tasks[0] = Task(name="sleep", driver="raw_exec", config={
                "command": "/bin/sleep", "args": [str(PLUGINS_SLEEP_S)]})
            task_pids = []
            with reaping_orphans(task_pids) as reaped:
                t0 = time.perf_counter()
                server.register_job(job)
                deadline = time.perf_counter() + PLUGINS_WAIT_S
                tr = None
                while tr is None or tr.handle is None or tr.state.state != "running":
                    assert time.perf_counter() < deadline, "the sleep task never ran"
                    time.sleep(0.05)
                    allocs = store.allocs_by_job("default", job.id)
                    runner = client.runners.get(allocs[0].id) if allocs else None
                    tr = runner.task_runners.get("sleep") if runner is not None else None
                pid = tr.handle.pid
                task_pids.append(pid)
                plugin = client.drivers["raw_exec"]
                old_plugin = plugin._proc
                old_plugin.kill()
                old_plugin.wait()
                t_kill = time.perf_counter()
                os.kill(pid, 0)  # the task outlived its plugin
                (alloc,) = wait_alloc(store, job.id)
                recovered_s = time.perf_counter() - t_kill
            events = [(e.type, e.exit_code) for e in tr.state.events]
            assert plugin._proc is not None and plugin._proc.pid != old_plugin.pid
            assert events[-2:] == [("Driver Failure", None), ("Terminated", 0)], events
            assert not tr.state.failed and reaped.get(pid) in (0, None), (tr.state, reaped)
            summary["reattach"] = {"kill_to_complete_s": recovered_s, "events": events,
                                   "reaped_exit_code": reaped.get(pid),
                                   "path_s": time.perf_counter() - t0}

            # (4) CSI: a volume's data across two allocs, unpublished at teardown
            server.register_csi_volume(CSIVolume(
                id="shared-vol", name="shared-vol", plugin_id="hostpath",
                access_mode=ACCESS_MODE_MULTI_NODE_MULTI_WRITER,
            ))
            t0 = time.perf_counter()
            runners = []
            for jid, script in (("writer", 'echo persisted > "$NOMAD_VOLUME_DATA/x"'),
                                ("reader", 'cat "$NOMAD_VOLUME_DATA/x" > "$NOMAD_ALLOC_DIR/copy"')):
                job = mock.batch_job()
                job.id = jid
                tg = job.task_groups[0]
                tg.count = 1
                tg.volumes = {"data": VolumeRequest(name="data", type="csi", source="shared-vol")}
                tg.tasks[0] = Task(name=jid, driver="raw_exec",
                                   config={"command": "/bin/sh", "args": ["-c", script]})
                server.register_job(job)
                (alloc,) = wait_alloc(store, jid)
                runners.append(client.runners[alloc.id])
            with open(os.path.join(csi_root, "shared-vol", "x")) as f:
                assert f.read().strip() == "persisted"
            with open(os.path.join(runners[1].alloc_dir, "shared", "copy")) as f:
                assert f.read().strip() == "persisted"
            targets = [os.path.join(r.alloc_dir, "volumes", "data") for r in runners]
            assert all(os.path.islink(t) for t in targets)
            client.gc_max_terminal_allocs = 0  # the client's GC tears them down
            deadline = time.perf_counter() + PLUGINS_WAIT_S
            while not all(r._destroyed and not r._published_volumes for r in runners):
                assert time.perf_counter() < deadline, "the CSI allocs were never torn down"
                time.sleep(0.05)
            assert not any(os.path.lexists(t) for t in targets)
            client.gc_max_terminal_allocs = 50
            summary["csi"] = {"seconds": time.perf_counter() - t0}

            # (5) the GPU fleet at the "server" cell's size
            t0 = time.perf_counter()
            server.raft_apply(MsgType.NODE_ELIGIBILITY,
                              {"node_id": client.node.id, "eligibility": "ineligible"})
            n_nodes = SERVER_BENCH["n_nodes"]
            for i in range(n_nodes):
                store.upsert_node(store.latest_index + 1, gpu_fleet_node(i))
            jobs = gpu_jobs()
            seed_s = time.perf_counter() - t0
            flight_recorder.clear()

            def timed_caps(*args, **kwargs):
                t = time.perf_counter()
                try:
                    return real_caps(*args, **kwargs)
                finally:
                    cap_s.append(time.perf_counter() - t)

            real_caps = flatten._device_slot_caps
            flatten._device_slot_caps = timed_caps
            t0 = time.perf_counter()
            for job in jobs:
                server.register_job(job)
            drained = server.wait_for_evals(timeout=600)
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
            flatten._device_slot_caps = real_caps
        launches = counters()
        assert drained, "the GPU fleet's evals did not drain"

        by_node = {n.id: n for n in store.nodes()}
        held = collections.Counter()
        placed = wrong_node = 0
        asked = {job.id: job.task_groups[0].tasks[0].resources.devices[0].count for job in jobs}
        for a in store.allocs():
            if a.job_id not in asked or a.terminal_status():
                continue
            placed += 1
            (ad,) = a.allocated_devices
            assert len(ad.device_ids) == asked[a.job_id], (a.job_id, ad.device_ids)
            group = {(d.id(), i.id) for d in by_node[a.node_id].node_resources.devices
                     for i in d.instances}
            wrong_node += not group or not {(ad.id(), d) for d in ad.device_ids} <= group
            held.update((a.node_id, ad.id(), d) for d in ad.device_ids)
        twice = sum(1 for c in held.values() if c > 1)
        total = sum(n * c for n, c, _ in (PLUGINS_SERVICE, PLUGINS_BATCH))
        traces = flight_recorder.traces()
        eval_s = [trace_latencies(t)[0] for t in traces]
        fallbacks = int(global_metrics.snapshot()["counters"].get(FALLBACK_CALLS, 0))
        overcommit = committed_overcommit(store)
        summary["fleet"] = {
            "config": f"{n_nodes} nodes ({n_nodes // PLUGINS_GPU_EVERY} with "
            f"{PLUGINS_GPU_INSTANCES} x nvidia/gpu/{PLUGINS_GPU_NAME}), "
            f"{PLUGINS_SERVICE[0]} service jobs x {PLUGINS_SERVICE[1]} of 1 instance, "
            f"{PLUGINS_BATCH[0]} batch jobs x {PLUGINS_BATCH[1]} of 8",
            "seed_s": seed_s, "elapsed_s": elapsed, "placed": placed, "total": total,
            "allocs_per_sec": placed / elapsed,
            "eval_latency_ms": {"evals": len(eval_s),
                                "p50": bench_torch.percentile_ms(eval_s, 50),
                                "p99": bench_torch.percentile_ms(eval_s, 99)},
            "device_caps_ms": {"calls": len(cap_s), "total": sum(cap_s) * 1e3,
                               "per_eval": sum(cap_s) * 1e3 / max(len(eval_s), 1),
                               "p50": bench_torch.percentile_ms(cap_s, 50),
                               "max": max(cap_s, default=0.0) * 1e3},
            "instances_held": len(held), "instances_twice": twice,
            "off_group": wrong_node, "committed_overcommit": overcommit,
            "phase_breakdown_ms": phase_breakdown(traces),
        }
        summary["fallback_calls"] = fallbacks
    finally:
        try:
            if agent is not None:
                agent.shutdown()
        finally:
            if old_root is None:
                os.environ.pop("NOMAD_CSI_HOSTPATH_ROOT", None)
            else:
                os.environ["NOMAD_CSI_HOSTPATH_ROOT"] = old_root
            shutil.rmtree(base, ignore_errors=True)
    summary["launches"] = launches
    summary["path_seconds"] = time.perf_counter() - t_path
    fleet = summary["fleet"]
    log("[plugins] the agent's plugins " + json.dumps(summary["plugins"], sort_keys=True))
    log("[plugins] dev node " + json.dumps(summary["dev_node"], sort_keys=True))
    log(f"[plugins] probe {summary['probe']}; reattach {summary['reattach']}; "
        f"csi {summary['csi']}; agent start {summary['agent_start_s']!r} s")
    log(
        f"[plugins] fleet {fleet['config']}: placed {placed}/{total} in {elapsed!r} s, "
        f"allocs_per_sec={fleet['allocs_per_sec']!r}, eval p50_ms="
        f"{fleet['eval_latency_ms']['p50']!r} p99_ms={fleet['eval_latency_ms']['p99']!r} "
        f"({len(eval_s)} evals); device caps host ms {fleet['device_caps_ms']}; instances held "
        f"{len(held)}, twice {twice}, off their node's group {wrong_node}, over-committed "
        f"nodes {overcommit}; seeding {seed_s!r} s; fallback calls {fallbacks}; launches "
        f"{launches}; path {summary['path_seconds']:.1f} s"
    )
    log("[plugins] phase_breakdown_ms " + json.dumps(fleet["phase_breakdown_ms"], sort_keys=True))
    assert placed == total, (placed, total)
    assert twice == 0, "a device instance is assigned twice"
    assert wrong_node == 0, "an alloc holds ids outside its node's group"
    assert overcommit == 0, "a node is over-committed in the store"
    assert fallbacks == 0, fallbacks
    assert launches["place_closed_form"] > 0
    assert all(n == 0 for k, n in launches.items() if k != "place_closed_form"), launches
    return launches, summary


# -- the "mesh" phase: the node-axis mesh on the card ---------------------------
#
# Meshes built explicitly: every cell names the card (cuda:0 repeated),
# so the sharded code runs for real on one H100 — a shard launch per
# cell, the cross-shard merge per groups row — and where the host has
# more than one card, again on distinct cards. Every other path of the
# script runs with NOMAD_TPU_MESH=off.

MESH_SHAPES = ((1, 4), (2, 2), (2, 4))
# bench.py kernel 100000 100 10000 --mesh 2,4: the reference's scaling
# configuration (100,000 nodes padded to 131,072, 100 groups x 100 allocs)
MESH_FLEET = {"n_nodes": 100_000, "n_groups": 100, "count": 100}
MESH_PLAIN_CHUNK = 16  # groups a plain closed-form call scores at once there
# __graft_entry__.dryrun_multichip's sizes: the value scan on 10,240 nodes
# x 75 racks (8 groups x 8), the closed form on that batch, and the
# region-major federation (40,960 nodes, a region a device)
MESH_DRYRUN = {"n_nodes": 10_240, "racks": 75, "groups": 8, "steps": 8,
               "fed_nodes": 40_960, "regions": 4}
MESH_SCHEDULE = (1, 4)  # the schedule recipe through Harness(mesh=...)


def mesh_devices(dev):
    """The devices a mesh's cells name: the one card, repeated."""
    return [dev] * 8


def mesh_of(dp, mp, devices):
    from nomad_tpu_torch import backend

    return backend.make_mesh(dp, mp, list(devices[: dp * mp]), source="chip_smoke")


@contextlib.contextmanager
def process_mesh(cfg):
    """The process mesh set to ``cfg`` for a block (the chaos runner's
    server resolves it), then restored."""
    from nomad_tpu_torch import backend

    with backend._mesh_lock:
        prev = backend._mesh_config
        backend._mesh_config = cfg
    try:
        yield cfg
    finally:
        with backend._mesh_lock:
            backend._mesh_config = prev


def shard_inputs(args, cfg, axes=None):
    """``args`` (the closed form's eleven inputs, or the score matrix's
    ten) laid out over ``cfg`` as the placement pass lays them out."""
    from nomad_tpu_torch import backend
    from nomad_tpu_torch.device import score as S

    axes = axes or [ax for _name, ax in S._CLOSED_FORM_AXES]
    return [backend.shard_put(x, ax, cfg) for x, ax in zip(args, axes)]


def plain_closed_form_chunked(args, spread, max_j, k, jitter=None, chunk=MESH_PLAIN_CHUNK):
    """``place_closed_form_plain`` a few groups at a time (each group is
    scored alone): its [G, N, J] planes at 131,072 nodes would not fit."""
    from nomad_tpu_torch.device import score as S

    g = args[2].shape[0]
    out_c, out_s = [], []
    for g0 in range(0, g, chunk):
        part = list(args[:2]) + [x[g0:g0 + chunk] for x in args[2:]]
        c, s = S.place_closed_form_plain(*part, spread, max_j, k, jitter)
        out_c.append(c)
        out_s.append(s)
    return torch.cat(out_c), torch.cat(out_s)


def feasible_candidates(args, spread, max_j, chunk=MESH_PLAIN_CHUNK) -> int:
    from nomad_tpu_torch.device import score as S

    total = 0
    for g0 in range(0, args[2].shape[0], chunk):
        part = list(args[:2]) + [x[g0:g0 + chunk] for x in args[2:]]
        _num, _den, fits = S._score_planes(*part, spread, max_j)
        total += int(fits.sum())
    return total


def same_bits(a, b) -> bool:
    return all(
        torch.equal(x.view(torch.int32), y.view(torch.int32)) for x, y in zip(a, b)
    )


def mesh_cells(sharded, cfg, g, n, max_j, k):
    """The parts each cell's shard launch reads (what
    ``place_closed_form_sharded`` cuts), by groups row: (rows, seg, k')."""
    from nomad_tpu_torch.device import score as S

    rows_split = cfg.dp if g % cfg.dp == 0 else 1
    gseg, seg = g // rows_split, n // cfg.mp
    kl = min(k, seg * max_j) if cfg.mp > 1 else k
    rows = []
    for i in range(rows_split):
        gs = slice(i * gseg, (i + 1) * gseg)
        cells = []
        for j in range(cfg.mp):
            ns = slice(j * seg, (j + 1) * seg)
            parts = []
            for x, (_name, axes) in zip(sharded, S._CLOSED_FORM_AXES):
                want = tuple(
                    gs if ax == "groups" else ns if ax == "nodes" else slice(0, x.shape[d])
                    for d, ax in enumerate(axes)
                )
                parts.append(S._cell_part(x, want, i, j, cfg.device(i, j)))
            cells.append(parts)
        rows.append(cells)
    return rows, seg, kl


def mesh_closed_form_case(label, args, spread, max_j, k, cfg, one, plain, feasible):
    """One mesh shape of (a) or (c): the sharded call identical (uint32
    views) to the one-device kernel and to plain; the shard launches',
    the merges' and the whole call's ms by CUDA-graph replay, each
    beside its bound; the form each shard launched."""
    from nomad_tpu_torch import backend
    from nomad_tpu_torch.device import score as S

    g, n = args[3].shape
    sharded = shard_inputs(args, cfg)
    S.place_closed_form.forms.clear()
    backend.reset_mesh_layouts()
    got = S.place_closed_form(*sharded, spread, max_j, k)
    torch.cuda.synchronize()
    forms = dict(S.place_closed_form.forms)
    layouts = backend.mesh_layouts()
    rows, seg, kl = mesh_cells(sharded, cfg, g, n, max_j, k)
    want_layouts = {"place_closed_form:shard": len(rows) * cfg.mp}
    if cfg.mp > 1:
        want_layouts["closed_form_topk_merge:merge"] = len(rows)
    assert layouts == want_layouts, (label, layouts, want_layouts)
    assert same_bits(got, one), f"mesh {label}: sharded differs from the one-device kernel"
    assert same_bits(got, plain), f"mesh {label}: sharded differs from plain"

    def shard_launches():
        return [
            [S._closed_form_one(*parts, spread, max_j, kl, None) for parts in cells]
            for cells in rows
        ]

    cands = shard_launches()
    merge_inputs = [
        ([c for c, _ in row], [s for _, s in row]) for row in cands
    ]
    out = {
        "mesh": [cfg.dp, cfg.mp], "rows": len(rows), "shards": len(rows) * cfg.mp,
        "nodes_per_shard": seg, "k_local": kl, "k": k, "identical": True,
        "shard_forms": {str(f): c for f, c in forms.items()},
        "shards_ms": graph_ms(shard_launches),
        "call_ms": graph_ms(lambda: S.place_closed_form(*sharded, spread, max_j, k)),
    }
    part_bytes = sum(nbytes(*parts) + parts[2].shape[0] * kl * 8
                     for cells in rows for parts in cells)
    t_bytes = part_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = feasible * CLOSED_FORM_OPS_PER_CANDIDATE / F32_OPS_PER_S * 1e3
    out["shards_bound_ms"] = max(t_bytes, t_ops)
    out["shards_bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    if cfg.mp > 1:
        merged = [S.closed_form_topk_merge(r, s, seg, k) for r, s in merge_inputs]
        plains = [S.closed_form_topk_merge_plain(r, s, seg, k) for r, s in merge_inputs]
        torch.cuda.synchronize()
        out["merge_mismatches"] = sum(int((a != b).sum()) for a, b in zip(merged, plains))
        assert out["merge_mismatches"] == 0, f"mesh {label}: merge differs from plain"
        merge = lambda: [S.closed_form_topk_merge(r, s, seg, k) for r, s in merge_inputs]  # noqa: E731
        plain_merge = lambda: [  # noqa: E731
            S.closed_form_topk_merge_plain(r, s, seg, k) for r, s in merge_inputs
        ]
        out["merge_ms"] = graph_ms(merge)
        out["merge_stream_ms"] = cuda_ms(merge)
        out["plain_merge_ms"] = graph_ms(plain_merge)
        out["plain_merge_stream_ms"] = cuda_ms(plain_merge)
        gr = g // len(rows)
        merge_bytes = len(rows) * (cfg.mp * gr * kl * 8 + gr * k * 8)
        out["merge_bound_ms"] = merge_bytes / HBM_BYTES_PER_S * 1e3
        out["merge_bound_by"] = "bytes"
    log(f"[mesh] {label}: " + json.dumps(out, sort_keys=True))
    return out


def mesh_closed_form(dev, devices, shapes=MESH_SHAPES, fleet=None):
    """(a) the closed form alone at the reference's scaling configuration,
    under each mesh of ``shapes`` and without one; and (b) the score
    matrix at G 100 on that fleet, sharded 1 x 4."""
    from nomad_tpu_torch.device import score as S

    fleet = fleet or MESH_FLEET
    ct = build_cluster(fleet["n_nodes"], seed=42)
    asks = build_asks(ct, fleet["n_groups"], fleet["count"], seed=7)
    b, max_j, k = device_batch(ct, asks, dev)
    args = closed_form_args(b)
    g, n = args[3].shape
    S.place_closed_form.forms.clear()
    one = S.place_closed_form(*args, False, max_j, k)
    torch.cuda.synchronize()
    one_forms = dict(S.place_closed_form.forms)
    plain = plain_closed_form_chunked(args, False, max_j, k)
    assert same_bits(one, plain), "mesh: the one-device kernel differs from plain"
    feasible = feasible_candidates(args, False, max_j)
    t_bytes = (nbytes(*args) + g * k * 8) / HBM_BYTES_PER_S * 1e3
    t_ops = feasible * CLOSED_FORM_OPS_PER_CANDIDATE / F32_OPS_PER_S * 1e3
    out = {
        "shape": f"G={g} ({fleet['n_groups']} real) N={n} J={max_j} k={k}",
        "unsharded": {
            "forms": {str(f): c for f, c in one_forms.items()},
            "ms": graph_ms(lambda: S.place_closed_form(*args, False, max_j, k)),
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        },
        "meshes": {},
    }
    log(f"[mesh] closed form unsharded {out['shape']}: " + json.dumps(out["unsharded"]))
    for dp, mp in shapes:
        cfg = mesh_of(dp, mp, devices)
        out["meshes"][f"{dp}x{mp}"] = mesh_closed_form_case(
            f"closed form {dp}x{mp}", args, False, max_j, k, cfg, one, plain, feasible,
        )
    # (b) the score matrix at G 100 on the same fleet, sharded 1 x 4
    sm_args = [b["capacity"], b["used0"]] + [
        b[key][: fleet["n_groups"]].contiguous() for key in (
            "asks", "eligible", "job_counts", "desired_totals", "penalty_nodes",
            "affinity_scores", "has_affinities", "distinct_hosts",
        )
    ]
    cfg = mesh_of(1, 4, devices)
    sm_one = S.score_matrix(*sm_args, False, None)
    sm_sharded = shard_inputs(sm_args, cfg, [ax for _n, ax in S._CLOSED_FORM_AXES[:10]])
    sm_got = S.score_matrix(*sm_sharded, False, None)
    torch.cuda.synchronize()
    assert same_bits(sm_got, sm_one), "mesh: the sharded score matrix differs"
    sm_bound, sm_by = score_matrix_bound(sm_args, None)
    out["score_matrix_1x4"] = {
        "shape": f"G={fleet['n_groups']} N={n}", "identical": True,
        "ms": graph_ms(lambda: S.score_matrix(*sm_sharded, False, None)),
        "unsharded_ms": graph_ms(lambda: S.score_matrix(*sm_args, False, None)),
        "bound_ms": sm_bound, "bound_by": sm_by,
    }
    log("[mesh] score matrix 1x4: " + json.dumps(out["score_matrix_1x4"]))
    return out


def example_batch(dev, n_nodes, n_groups, max_steps, v, b=2):
    """``__graft_entry__._example_batch`` (the reference dryrun's inputs)
    on ``dev``: capacities of 4,000 / 8,000 MHz and 8 / 16 GiB, 0-30 %
    used, 500 MHz / 256 MiB asks, an even-spread block and a loose
    distinct cap over ``v`` rack values."""
    rng = np.random.default_rng(0)
    pn, g = n_nodes, n_groups
    capacity = np.zeros((pn, 4), dtype=np.float32)
    capacity[:, 0] = rng.choice([4000, 8000], pn)
    capacity[:, 1] = rng.choice([8192, 16384], pn)
    capacity[:, 2] = 100 * 1024
    capacity[:, 3] = 1000
    used = (capacity * rng.uniform(0, 0.3, (pn, 1))).astype(np.float32)
    value_ids = np.zeros((g, b, pn), dtype=np.int32)
    value_ids[:, 0, :] = np.arange(pn) % v
    value_ids[:, 1, :] = np.arange(pn) % v
    kinds = np.zeros((g, b), dtype=np.int32)
    kinds[:, 0] = 1  # BLOCK_EVEN_SPREAD
    kinds[:, 1] = 2  # BLOCK_DISTINCT_CAP
    caps = np.full((g, b, v), np.inf, dtype=np.float32)
    caps[:, 1, :] = float(max_steps)
    host = dict(
        capacity=capacity, used0=used,
        asks=np.tile(np.array([[500, 256, 300, 0]], dtype=np.float32), (g, 1)),
        eligible=np.ones((g, pn), dtype=bool),
        job_counts=np.zeros((g, pn), dtype=np.int32),
        desired_totals=np.full(g, float(max_steps), dtype=np.float32),
        penalty_nodes=np.zeros((g, pn), dtype=bool),
        affinity_scores=np.zeros((g, pn), dtype=np.float32),
        has_affinities=np.zeros(g, dtype=bool),
        distinct_hosts=np.zeros(g, dtype=bool),
        slot_caps=np.full((g, pn), np.inf, dtype=np.float32),
        block_value_ids=value_ids,
        block_counts0=np.zeros((g, b, v), dtype=np.float32),
        block_desired=np.full((g, b, v), -1.0, dtype=np.float32),
        block_caps=caps,
        block_weights=np.full((g, b), 1.0, dtype=np.float32),
        block_kinds=kinds,
        counts=np.full(g, max_steps, dtype=np.int32),
    )
    return host, {k: torch.from_numpy(v).to(dev) for k, v in host.items()}


def mesh_dryrun(dev, devices, sizes=None):
    """(c) the counterpart of ``__graft_entry__.dryrun_multichip`` at its
    own sizes on a mesh of 4 cells (2 x 2), the federation on 1 x 4:
    every output identical to the unsharded call."""
    from nomad_tpu_torch import backend
    from nomad_tpu_torch.device import score as S

    sz = sizes or MESH_DRYRUN
    cfg = mesh_of(2, 2, devices)
    host, t = example_batch(dev, sz["n_nodes"], sz["groups"], sz["steps"], sz["racks"])
    specs = dict(S._BATCH_SPECS, capacity=("nodes",), used0=("nodes",))
    sharded = {k: backend.shard_put(v, specs[k], cfg) for k, v in t.items()}
    one = S.place_value_scan(**t, algorithm_spread=False, max_j=16, max_steps=sz["steps"])
    backend.reset_mesh_layouts()
    got = S.place_value_scan(**sharded, algorithm_spread=False, max_j=16, max_steps=sz["steps"])
    plain = S.place_value_scan_plain(**t, algorithm_spread=False, max_j=16,
                                     max_steps=sz["steps"])
    torch.cuda.synchronize()
    assert same_bits(got, one) and same_bits(got, plain), "mesh dryrun: value scan differs"
    assert (got[0] >= 0).all(), "mesh dryrun: a value-scan placement failed"
    layouts = backend.mesh_layouts()
    assert set(layouts) == {"coupled_shard_step:shard", "coupled_step_merge:merge",
                            "coupled_shard_apply:shard"}, layouts
    bound = coupled_bound(
        "place_value_scan",
        dict(t, algorithm_spread=False, max_j=16, max_steps=sz["steps"]), plain[0],
    )
    out = {"value_scan": {"identical": True, "layouts": layouts,
                          "ms": cuda_ms(lambda: S.place_value_scan(
                              **sharded, algorithm_spread=False, max_j=16,
                              max_steps=sz["steps"])),
                          "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
                          "steps_per_launch": int(bound["steps"].max())}}
    log("[mesh] dryrun value scan 2x2: " + json.dumps(out["value_scan"], sort_keys=True))
    cf_keys = [name for name, _ax in S._CLOSED_FORM_AXES]
    args = [t[k] for k in cf_keys]
    one_cf = S.place_closed_form(*args, False, 16, 16)
    plain_cf = S.place_closed_form_plain(*args, False, 16, 16)
    out["closed_form"] = mesh_closed_form_case(
        "dryrun closed form 2x2", args, False, 16, 16, cfg, one_cf, plain_cf,
        feasible_candidates(args, False, 16),
    )
    assert (one_cf[0][:, : sz["steps"]] >= 0).all()
    # the region-major federation: a region a cell, each group eligible in
    # its home region only
    fed, per = sz["fed_nodes"], sz["fed_nodes"] // sz["regions"]
    host, t = example_batch(dev, fed, sz["groups"], 4, sz["racks"])
    rows = np.arange(fed)
    for g in range(sz["groups"]):
        host["eligible"][g] = (rows // per) == g % sz["regions"]
    t["eligible"] = torch.from_numpy(host["eligible"]).to(dev)
    args = [t[k] for k in cf_keys]
    region = mesh_of(1, sz["regions"], devices)
    one_r = S.place_closed_form(*args, False, 4, 4)
    plain_r = S.place_closed_form_plain(*args, False, 4, 4)
    out["federation"] = mesh_closed_form_case(
        f"federation 1x{sz['regions']}", args, False, 4, 4, region, one_r, plain_r,
        feasible_candidates(args, False, 4),
    )
    ch = one_r[0].cpu().numpy()
    assert (ch >= 0).all(), "mesh federation: a placement failed"
    for g in range(sz["groups"]):
        assert ((ch[g] // per) == g % sz["regions"]).all(), "mesh federation: left its region"
    return out


class GatheredRecorder(Recorder):
    """A ``Recorder`` for a wrapper whose inputs may lie over a mesh: keeps
    each call's inputs gathered onto the lead, its outputs, and whether
    any input was sharded (the recorded calls are replayed through the
    plain version after the counts are read)."""

    def __call__(self, *args, **kwargs):
        from nomad_tpu_torch import backend

        with self.lock:
            out = self.real(*args, **kwargs)
            self.calls.append({
                "sharded": any(backend.is_sharded(a) for a in (*args, *kwargs.values())),
                "args": [backend.gather(a) for a in args],
                "kwargs": {k: backend.gather(v) for k, v in kwargs.items()},
                "out": [x.clone() for x in out],
            })
        return out


def assignment(h, jobs) -> dict:
    return {
        (j.id, a.name): a.node_id
        for j in jobs for a in h.store.allocs_by_job(j.namespace, j.id)
        if not a.terminal_status()
    }


def mesh_schedule(dev, devices, nodes=None, jobs=None, shape=MESH_SCHEDULE):
    """(d) the schedule recipe through ``Harness(mesh=1 x 4)``, the score
    seam on: the same alloc -> node assignment as without a mesh; one node
    update re-uploads one shard refresh and no whole tensor, and both
    device views copy back bitwise; a dropped shard refresh recovers by a
    whole upload. Returns (launch counts of the mesh run, its recorded
    closed-form calls, a summary)."""
    from nomad_tpu_torch import backend
    from nomad_tpu_torch.chaos.plane import FaultPlane, FaultSpec, install, uninstall
    from nomad_tpu_torch.device import score as S

    if nodes is None:
        nodes, jobs = schedule_fleet()
    cfg = mesh_of(*shape, devices)
    out = {"mesh": list(shape), "devices": cfg.describe()["devices"]}
    with incremental_seam(True):
        h0 = fleet_harness(dev, nodes, jobs)
        t0 = time.perf_counter()
        for j in jobs:
            h0.process(eval_of(h0, j, "plain"))
        torch.cuda.synchronize()
        out["unsharded_seconds"] = time.perf_counter() - t0
        want = assignment(h0, jobs)
        del h0
        h = fleet_harness(dev, nodes, jobs, mesh=cfg)
        zero_counters()
        backend.reset_mesh_layouts()
        with recording(S, "place_closed_form", GatheredRecorder) as calls:
            t0 = time.perf_counter()
            for j in jobs:
                h.process(eval_of(h, j, "mesh"))
            torch.cuda.synchronize()
            out["seconds"] = time.perf_counter() - t0
        launches = counters()
        out["layouts"] = backend.mesh_layouts()
        got = assignment(h, jobs)
        assert got == want, "mesh: the alloc -> node assignment differs from the run without"
        assert len(got) == sum(j.task_groups[0].count for j in jobs), "mesh: not every alloc placed"
        cache = h.device_cache
        before = cache.device_counters()
        node = copy.deepcopy(h.store.node_by_id(nodes[len(nodes) // 2].id))
        node.node_resources.cpu += 100
        h.store.upsert_node(h.next_index(), node)
        cache.tensors(h.store.snapshot())
        after = cache.device_counters()
        assert after["shard_uploads"] == before["shard_uploads"] + 1, (before, after)
        assert after["full_uploads"] == before["full_uploads"], (before, after)
        assert cache.verify_device_view() == [], "mesh: a capacity shard diverged"
        assert cache.verify_score_view() == [], "mesh: a score shard diverged"
        node = copy.deepcopy(h.store.node_by_id(nodes[1].id))
        node.node_resources.cpu += 100
        h.store.upsert_node(h.next_index(), node)
        plane = FaultPlane(schedule=[FaultSpec("mesh.shard_refresh_drop", 0, "drop")])
        install(plane)
        try:
            cache.tensors(h.store.snapshot())
        finally:
            uninstall()
        dropped = cache.device_counters()
        assert ("mesh.shard_refresh_drop", 0, "drop") in plane.triggered
        assert dropped["full_uploads"] == after["full_uploads"] + 1, dropped
        assert dropped["shard_uploads"] == after["shard_uploads"], dropped
        assert cache.verify_device_view() == []
        out.update(cache_before=before, cache_after_update=after, cache_after_drop=dropped)
    assert calls and all(c["sharded"] for c in calls), "mesh: a closed-form call was not sharded"
    out["calls"] = len(calls)
    return launches, calls, out


def replay_mesh_calls(calls, cfg) -> dict:
    """Every recorded closed-form call of the mesh path through the plain
    version on its gathered inputs: identical outputs (uint32 views).
    Then each call's kernels timed by graph replay, laid out over ``cfg``
    again (shard launches, merge, copies) and on one device, summed over
    the path (``path_ms``, ``unsharded_path_ms``)."""
    from nomad_tpu_torch import backend
    from nomad_tpu_torch.device import score as S

    mismatches = 0
    path_ms = unsharded_ms = 0.0
    for c in calls:
        want = S.place_closed_form_plain(*c["args"], **c["kwargs"])
        if not same_bits(c["out"], want):
            mismatches += 1
        bound = inspect.signature(S.place_closed_form).bind(*c["args"], **c["kwargs"])
        bound.apply_defaults()
        a = bound.arguments
        args = [a[name] for name, _axes in S._CLOSED_FORM_AXES]
        statics = (a["algorithm_spread"], a["max_j"], a["k"])
        jitter = a["jitter"]
        sharded = shard_inputs(args, cfg)
        sj = None if jitter is None else backend.shard_put(jitter, ("nodes",), cfg)
        path_ms += graph_ms(lambda: S.place_closed_form(*sharded, *statics, sj))
        unsharded_ms += graph_ms(lambda: S.place_closed_form(*args, *statics, jitter))
    assert mismatches == 0, f"mesh: {mismatches} recorded calls differ from plain"
    return {"calls": len(calls), "identical": True, "path_ms": path_ms,
            "unsharded_path_ms": unsharded_ms}


def mesh_chaos(dev, devices):
    """(e) one chaos run with the process mesh 1 x 4 on the card, on the
    "resilience" workload at its size with a node re-registered at every
    settle point (``run_chaos(node_touches=True)``: the cache's per-shard
    capacity refresh runs during the run), ``mesh.shard_refresh_drop``
    scheduled on its first refresh beside the seeded fault mix: the drop
    fires and is recovered by a whole upload, later refreshes upload
    shards, and law 12's capacity half is checked and passes."""
    from nomad_tpu_torch.chaos import FaultPlane, FaultSpec
    from nomad_tpu_torch.chaos.runner import FAULT_KINDS

    seed = RESILIENCE_SEEDS[0]
    planned = FaultPlane(seed=seed, steps=RESILIENCE_STEPS, faults=FAULT_KINDS, rate=0.04)
    schedule = list(planned.schedule) + [FaultSpec("mesh.shard_refresh_drop", 0, "drop")]
    with process_mesh(mesh_of(1, 4, devices)):
        run, summary, launches = chaos_on(
            dev, "mesh 1x4", seed=seed, steps=RESILIENCE_STEPS, nodes=RESILIENCE_NODES,
            schedule=schedule, node_touches=True,
        )
    halves = run.report.info["shard_consistency"]
    cache = run.report.info.get("device_cache")
    assert halves["capacity"] == "checked", halves
    assert run.report.checked.get("shard_consistency") is True, run.render()
    assert ("mesh.shard_refresh_drop", 0, "drop") in run.triggered, run.triggered
    # the first whole upload, the drop's recovery, and per-shard refreshes
    assert cache["full_uploads"] >= 2 and cache["shard_uploads"] >= 1, cache
    return {
        "ok": run.ok, "halves": halves, "seconds": summary["seconds"],
        "node_touches": run.workload["node_touches"],
        "shard_refresh_drops": sum(
            t[0] == "mesh.shard_refresh_drop" for t in run.triggered
        ),
        "fallback_calls": summary["fallback_calls"],
        "device_cache": cache,
        "launches": summary["launches"],
    }


# (f) the coupled scans on the mesh: each scan alone at MESH_FLEET's
# 100,000 nodes (131,072 padded) under every MESH_SHAPES mesh, against the
# one-device kernel and the plain version; and (g) the spread recipe
# through Harness(mesh=1x4), against the unsharded Harness

MESH_SCANS = {"groups": 16, "racks": 250, "value_steps": 32, "chunks": 8}
MESH_SCAN_TIMED = 5  # sharded calls timed a case (a launch a cell a step: ms each)
MESH_SPREAD = (1, 4)  # the spread recipe through Harness(mesh=...)
MESH_SCAN_NAMES = {"value_scan": "place_value_scan", "chunked": "place_spread_chunked",
                   "opv": "place_spread_opv"}


def mesh_scan_inputs(dev, kind, sz=None):
    """One scan's inputs at MESH_FLEET's size: the dryrun's batch (an even
    spread and a loose distinct cap over ``racks`` values, 16 groups) on
    100,000 nodes padded to 131,072 (the padding rows empty and eligible
    nowhere), block 0 a target spread for the chunked scan; and the
    scan's statics."""
    from nomad_tpu_torch.device import score as S

    sz = sz or MESH_SCANS
    n = MESH_FLEET["n_nodes"]
    pn = 1 << (n - 1).bit_length()
    g, steps = sz["groups"], sz["value_steps"]
    host, _ = example_batch(dev, pn, g, steps, sz["racks"])
    host["capacity"][n:] = 0.0
    host["used0"][n:] = 0.0
    host["eligible"][:, n:] = False
    host["block_value_ids"][:, :, n:] = -1
    if kind == "value_scan":
        statics = {"max_steps": steps}
    else:
        host["counts"][:] = sz["chunks"] * S.CHUNK
        if kind == "chunked":
            host["block_kinds"][:, 0] = S.BLOCK_TARGET_SPREAD
            host["block_desired"][:, 0, :] = 2.0
            statics = {"chunk": S.CHUNK, "n_chunks": sz["chunks"]}
        else:
            host["enforce_idx"] = np.zeros(g, dtype=np.int32)
            statics = {"k_seg": min(S.CHUNK, sz["racks"] + 1), "n_chunks": sz["chunks"]}
    t = {k: torch.from_numpy(v).to(dev) for k, v in host.items()}
    return t, dict(statics, algorithm_spread=False, max_j=16)


def expected_mesh_launches(kind, steps, rows, mp) -> dict:
    """Launches of one sharded scan call: a shard step a cell a step (two
    for one-per-value), a merge a groups row a step (two), an apply a cell
    a step."""
    sweeps = 2 if kind == "opv" else 1
    return {
        "coupled_shard_step": steps * rows * mp * sweeps,
        "coupled_step_merge": steps * rows * sweeps,
        "coupled_shard_apply": steps * rows * mp,
    }


def mesh_scan_case(kind, t, statics, cfg, one, plain, steps):
    """One scan under one mesh: the sharded call identical (uint32 views)
    to the one-device kernel and to plain, its launches and layouts, and
    its ms (CUDA events: the step loop makes streams and events, which a
    graph does not capture) and µs a step."""
    from nomad_tpu_torch import backend
    from nomad_tpu_torch.device import score as S

    name = MESH_SCAN_NAMES[kind]
    specs = dict(S._BATCH_SPECS, capacity=("nodes",), used0=("nodes",))
    sharded = {k: v if k == "enforce_idx" else backend.shard_put(v, specs[k], cfg)
               for k, v in t.items()}
    call = lambda: getattr(S, name)(**sharded, **statics)  # noqa: E731
    zero_counters()
    backend.reset_mesh_layouts()
    got = call()
    torch.cuda.synchronize()
    launches = {n: getattr(S, n).launches for n in MESH_COUPLED}
    layouts = backend.mesh_layouts()
    g = t["asks"].shape[0]
    rows = cfg.dp if g % cfg.dp == 0 else 1
    label = f"{kind} {cfg.dp}x{cfg.mp}"
    assert same_bits(got, one), f"mesh {label}: sharded differs from the one-device kernel"
    assert same_bits(got, plain), f"mesh {label}: sharded differs from plain"
    assert launches == expected_mesh_launches(kind, steps, rows, cfg.mp), (label, launches)
    assert not any(k.endswith(":gathered") for k in layouts), (label, layouts)
    ms = cuda_ms(call, iters=MESH_SCAN_TIMED, warmup=1)
    return {
        "mesh": [cfg.dp, cfg.mp], "identical": True, "ms": ms,
        "us_per_step": ms * 1e3 / steps, "launches": launches, "layouts": layouts,
    }


def mesh_coupled_scans(dev, devices, shapes=MESH_SHAPES, sz=None):
    """(f) each coupled scan at 131,072 padded nodes: the one-device
    kernel (graph replay) beside its bound (``coupled_bound``) and the
    plain version, then the sharded call under each mesh."""
    from nomad_tpu_torch.device import score as S

    out = {}
    for kind, name in MESH_SCAN_NAMES.items():
        t, statics = mesh_scan_inputs(dev, kind, sz)
        steps = statics.get("max_steps", statics.get("n_chunks"))
        kernel, plain_fn = getattr(S, name), getattr(S, f"{name}_plain")
        one = kernel(**t, **statics)
        plain = plain_fn(**t, **statics)
        torch.cuda.synchronize()
        assert same_bits(one, plain), f"mesh {kind}: the one-device kernel differs from plain"
        bound = coupled_bound(name, dict(t, **statics), plain[0])
        g, n = t["eligible"].shape
        res = {
            "shape": f"G={g} N={n} J=16 B={t['block_counts0'].shape[1]} "
                     f"V={t['block_counts0'].shape[2]}",
            "steps": steps, "picks": bound["picks"],
            "unsharded_ms": graph_ms(lambda: kernel(**t, **statics)),
            "plain_ms": cuda_ms(lambda: plain_fn(**t, **statics), iters=1, warmup=0),
            "bound_ms": bound["bound_ms"], "bound_by": bound["bound_by"],
            "meshes": {
                f"{dp}x{mp}": mesh_scan_case(kind, t, statics, mesh_of(dp, mp, devices),
                                             one, plain, steps)
                for dp, mp in shapes
            },
        }
        res["unsharded_us_per_step"] = res["unsharded_ms"] * 1e3 / steps
        log(f"[mesh] coupled {kind}: " + json.dumps(res, sort_keys=True))
        out[name] = res
        del t, one, plain
    return out


def mesh_spread(dev, devices, shape=MESH_SPREAD):
    """(g) the spread recipe (the "spread" path's 10,000 nodes and 30 jobs)
    through ``Harness(mesh=1x4)``: every coupled pass runs the sharded
    scans, and the allocs land as without the mesh, as (job, node) counts
    (ROADMAP C-S1). Its launch counts are read around the mesh run alone:
    every coupled launch is a shard step, merge or apply ("shard" or
    "merge"), none the one-device scans', none gathered, no fallback.
    Returns (the launch counts, the recorded one-per-value and chunked
    calls, a summary)."""
    from nomad_tpu_torch import backend
    from nomad_tpu_torch.device import score as S
    from nomad_tpu_torch.utils.metrics import global_metrics

    cfg = mesh_of(*shape, devices)
    nodes = spread_fleet()
    jobs = [j for _, j in spread_jobs()]

    def run(mesh):
        h = fleet_harness(dev, nodes, jobs, mesh=mesh)
        t0 = time.perf_counter()
        for j in jobs:
            h.process(eval_of(h, j, "spread"))
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        placed = collections.Counter(
            (j.id, a.node_id) for j in jobs
            for a in h.store.allocs_by_job(j.namespace, j.id) if not a.terminal_status()
        )
        return placed, seconds, sum(j.task_groups[0].count for j in jobs)

    want, unsharded_s, total = run(None)
    fallback0 = global_metrics.snapshot()["counters"].get(FALLBACK_CALLS, 0)
    zero_counters()
    backend.reset_mesh_layouts()
    with recording(S, "place_spread_opv", GatheredRecorder) as calls, \
            recording(S, "place_spread_chunked", GatheredRecorder) as chunked:
        got, seconds, _ = run(cfg)
    launches = counters()
    layouts = backend.mesh_layouts()
    fallback = global_metrics.snapshot()["counters"].get(FALLBACK_CALLS, 0) - fallback0
    assert got == want, "mesh spread: the (job, node) counts differ from the run without"
    assert sum(got.values()) == total, "mesh spread: not every alloc placed"
    assert all(launches[n] > 0 for n in MESH_COUPLED), launches
    assert all(launches[n] == 0 for n in COUPLED), launches
    assert set(layouts) == {"coupled_shard_step:shard", "coupled_step_merge:merge",
                            "coupled_shard_apply:shard"}, layouts
    assert fallback == 0, fallback
    assert calls and all(c["sharded"] for c in calls), "mesh spread: an opv call was not sharded"
    assert chunked and all(c["sharded"] for c in chunked), \
        "mesh spread: a chunked call was not sharded"
    out = {"mesh": list(shape), "seconds": seconds, "unsharded_seconds": unsharded_s,
           "allocs": total, "identical": True, "layouts": layouts, "fallback_calls": fallback,
           "opv_calls": len(calls), "chunked_calls": len(chunked)}
    log("[mesh] spread recipe " + json.dumps(out, sort_keys=True))
    return launches, (calls, chunked), out


def mesh_cells_of(a, mp):
    """A recorded coupled call's gathered inputs ``a`` cut into ``mp``
    node slices, as a 1 x ``mp`` mesh's cells hold them (the counts
    ride in the record)."""
    from nomad_tpu_torch.device import score as S

    seg = a["eligible"].shape[1] // mp
    cells = []
    for j in range(mp):
        cell = {}
        for name, axes in S._COUPLED_AXES:
            if name == "block_counts0":  # the record carries the counts
                continue
            x = a[name]
            if "nodes" in axes:
                d = axes.index("nodes")
                x = x.narrow(d, j * seg, seg).contiguous()
            cell[name] = x
        if a.get("jitter") is not None:
            cell["jitter"] = a["jitter"][j * seg:(j + 1) * seg].contiguous()
        cells.append(cell)
    return cells


def mesh_chunked_step_check(call, mp):
    """One step of a recorded chunked call of the spread recipe's mesh
    run, cut into ``mp`` node slices: every cell's top ``chunk`` of its
    clamped plane (``coupled_shard_step``, segments off), the rank merge
    (``coupled_step_merge`` "chunked") and every cell's apply, each
    identical to its plain version on the same inputs. Returns what the
    step took."""
    from nomad_tpu_torch.device import score as S

    a = call["kwargs"]
    cells = mesh_cells_of(a, mp)
    g, n = a["eligible"].shape
    seg = n // mp
    nb, nv = a["block_counts0"].shape[1:]
    chunk = a["chunk"]
    dev = a["capacity"].device
    record = S._record_start(a["block_counts0"], nb, nv)
    jn = torch.zeros((g, seg), dtype=torch.int32, device=dev)
    present = torch.zeros((g, nv), dtype=torch.int32, device=dev)
    common = dict(counts=a["counts"], enforce_idx=None, jn=jn,
                  algorithm_spread=a["algorithm_spread"], max_j=a["max_j"], record=record,
                  segments=False, chunk=chunk, first_step=False)
    merge_args = (record, a["counts"], a["block_kinds"], None, present, "chunked", chunk, False)
    step_c = [S.coupled_shard_step(**cells[j], **common, col0=j * seg) for j in range(mp)]
    step_p = [S.coupled_shard_step_plain(**cells[j], **common, col0=j * seg) for j in range(mp)]
    merged = S.coupled_step_merge(torch.stack(step_c), *merge_args)
    merged_p = S.coupled_step_merge_plain(torch.stack(step_p), *merge_args)
    app_c = [S.coupled_shard_apply(jn, merged[0], j * seg) for j in range(mp)]
    app_p = [S.coupled_shard_apply_plain(jn, merged[0], j * seg) for j in range(mp)]
    torch.cuda.synchronize()
    for what, got, want in (
        ("coupled_shard_step (chunked)", step_c, step_p),
        ("coupled_step_merge (chunked)", list(merged), list(merged_p)),
        ("coupled_shard_apply (chunked)", app_c, app_p),
    ):
        assert same_bits(got, want), f"mesh: {what} differs from its plain version"
    took = int(merged[0][:, 0].sum())
    assert took > 0, "mesh: the checked chunked step took nothing"
    return {"shape": f"G={g} S={mp} cells x {seg} nodes, B={nb} V={nv}, chunk={chunk}",
            "identical": True, "took": took}


def mesh_kernel_checks(calls, shape=MESH_SPREAD):
    """Each mesh kernel of the coupled scans on recorded calls of the
    spread recipe's mesh run, their gathered inputs cut into ``shape``'s
    node slices, groups row 0. The one-per-value scan: one step's first
    picks and segment maxima on every cell (``coupled_shard_step``), the
    two merges (``coupled_step_merge``) and every cell's apply
    (``coupled_shard_apply``); the chunked scan: one step of each
    (``mesh_chunked_step_check``). Each against its plain version on the
    same inputs (outputs identical). The one-per-value step's kernels are
    timed by graph replay (the plain versions by CUDA events), beside
    their bounds: the inputs read once and the outputs written once over
    the memory rate, or (the shard step) each slice node's head and score
    in f32 operations over the peak rate."""
    from nomad_tpu_torch.device import score as S

    opv_calls, chunked_calls = calls
    call = opv_calls[-1]
    a = call["kwargs"]
    mp = shape[1]
    g, n = a["eligible"].shape
    seg = n // mp
    nb, nv = a["block_counts0"].shape[1:]
    k_seg = a["k_seg"]
    cells = mesh_cells_of(a, mp)
    chunked_step = mesh_chunked_step_check(chunked_calls[-1], mp)
    dev = a["capacity"].device
    record = S._record_start(a["block_counts0"], nb, nv)
    jn = torch.zeros((g, seg), dtype=torch.int32, device=dev)
    present = torch.zeros((g, nv), dtype=torch.int32, device=dev)
    common = dict(counts=a["counts"], enforce_idx=a["enforce_idx"], jn=jn,
                  algorithm_spread=a["algorithm_spread"], max_j=a["max_j"])

    def steps(fn, rec, segments, first_step):
        return [fn(**cells[j], **common, record=rec, segments=segments,
                   chunk=k_seg if segments else 1, col0=j * seg, first_step=first_step)
                for j in range(mp)]

    merge_args = (a["counts"], a["block_kinds"], a["enforce_idx"])
    first_c = steps(S.coupled_shard_step, record, False, False)
    first_p = steps(S.coupled_shard_step_plain, record, False, False)
    first_m = S.coupled_step_merge(torch.stack(first_c), record, *merge_args, present,
                                   "first", k_seg, False)
    first_mp = S.coupled_step_merge_plain(torch.stack(first_p), record, *merge_args, present,
                                          "first", k_seg, False)
    rec1 = first_m[0]
    seg_c = steps(S.coupled_shard_step, rec1, True, True)
    seg_p = steps(S.coupled_shard_step_plain, rec1, True, True)
    seg_m = S.coupled_step_merge(torch.stack(seg_c), rec1, *merge_args, first_m[1],
                                 "segments", k_seg, True)
    seg_mp = S.coupled_step_merge_plain(torch.stack(seg_p), rec1, *merge_args, first_m[1],
                                        "segments", k_seg, True)
    rec2 = seg_m[0]
    app_c = [S.coupled_shard_apply(jn, rec2, j * seg) for j in range(mp)]
    app_p = [S.coupled_shard_apply_plain(jn, rec2, j * seg) for j in range(mp)]
    torch.cuda.synchronize()
    for what, got, want in (
        ("coupled_shard_step", first_c + seg_c, first_p + seg_p),
        ("coupled_step_merge", [*first_m, *seg_m], [*first_mp, *seg_mp]),
        ("coupled_shard_apply", app_c, app_p),
    ):
        assert same_bits(got, want), f"mesh: {what} differs from its plain version"
    assert int(rec2[:, 0].sum()) > 0, "mesh: the checked step took nothing"

    gathered1, gathered2 = torch.stack(first_c), torch.stack(seg_c)
    shard = lambda fn: steps(fn, rec1, True, True)  # noqa: E731
    merge = lambda fn: fn(gathered2, rec1, *merge_args, first_m[1], "segments", k_seg, True)  # noqa: E731
    apply = lambda fn: [fn(jn, rec2, j * seg) for j in range(mp)]  # noqa: E731
    cell_bytes = nbytes(*[x for x in cells[0].values()], jn, record)
    ops = g * seg * (CLOSED_FORM_OPS_PER_CANDIDATE + COUPLED_OPS_PER_NODE
                     + COUPLED_OPS_PER_BLOCK * nb) + g * nb * nv * COUPLED_OPS_PER_TABLE_ENTRY
    bounds = {
        "coupled_shard_step": (mp * (cell_bytes + nbytes(seg_c[0])), mp * ops),
        "coupled_step_merge": (nbytes(gathered2, rec1, *seg_m), 0),
        "coupled_shard_apply": (mp * nbytes(jn, rec2, jn), 0),
    }
    shapes = {
        "coupled_shard_step": f"G={g} S={mp} cells x {seg} nodes, B={nb} V={nv}, segments "
                              f"(the one-per-value scan's second exchange)",
        "coupled_step_merge": f"G={g} S={mp} lists of V+1={nv + 1} segments, k_seg={k_seg}",
        "coupled_shard_apply": f"G={g} S={mp} cells x {seg} nodes",
    }
    out = {}
    for name, (fn, plain) in {
        "coupled_shard_step": (lambda: shard(S.coupled_shard_step),
                               lambda: shard(S.coupled_shard_step_plain)),
        "coupled_step_merge": (lambda: merge(S.coupled_step_merge),
                               lambda: merge(S.coupled_step_merge_plain)),
        "coupled_shard_apply": (lambda: apply(S.coupled_shard_apply),
                                lambda: apply(S.coupled_shard_apply_plain)),
    }.items():
        b, o = bounds[name]
        t_bytes = b / HBM_BYTES_PER_S * 1e3
        t_ops = o / F32_OPS_PER_S * 1e3
        launches = mp if name != "coupled_step_merge" else 1
        out[name] = {
            "max_abs_err": 0.0, "choice_mismatches": 0,
            "ms": graph_ms(fn) / launches, "stream_ms": cuda_ms(fn) / launches,
            "plain_ms": cuda_ms(plain, iters=3, warmup=1) / launches,
            "bound_ms": max(t_bytes, t_ops) / launches,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "shape": shapes[name] + " (a launch)",
        }
        out[name]["plain_stream_ms"] = out[name]["plain_ms"]
    out["chunked_step"] = chunked_step
    log("[mesh] coupled kernels " + json.dumps(out, sort_keys=True))
    return out


# (h) the hetero, CP and gang passes on the mesh at their batch paths'
# shapes (10,000 nodes, 16,384 padded) under every MESH_SHAPES mesh; (i)
# the "hetero", "cp" and "gang" recipes through their kernel objects under
# MESH_PLUGIN_RECIPES; (j) each of their mesh kernels alone against its
# plain version

MESH_PLUGIN_TIMED = 3  # sharded calls timed a case
MESH_PLUGIN_RECIPES = (1, 4)
# the reference's layout of each pass's inputs (plugin_args' order; its
# shard_put calls; () on the lead, None not a tensor)
_CP_MESH_AXES = (("nodes",), ("nodes",), ("groups",), ("groups",), ("groups", "nodes"),
                 ("groups", "nodes"), ("groups",), ("groups", "nodes"), ("groups",), ())
MESH_PLUGIN_AXES = {
    "hetero_place": (("nodes",), ("nodes",), ("groups",), ("groups",), ("groups", "nodes"),
                     ("groups", "nodes"), ("groups",), ()),
    "cp_place": _CP_MESH_AXES + ((),),
    "cp_gang_place_ids": _CP_MESH_AXES + ((), (), (), (), (None, "nodes"), None, ()),
}
# each pass's merge kernel: its launches are the steps or rounds run
MESH_PLUGIN_MERGE = {"hetero_place": "hetero_step_merge", "cp_place": "cp_round_merge",
                     "cp_gang_place": "cp_round_merge"}


def mesh_plugin_inputs():
    """(label, kernel name, wrapper, inputs, statics) of the batch paths'
    last recorded calls: each hetero policy's, cp_batch's and the
    10,000-node gang_batch call."""
    from nomad_tpu_torch.scheduler import hetero as H

    out = []
    for policy, pid in H.POLICY_IDS.items():
        call = [c for c in MESH_BATCH_CALLS["hetero_batch"] if c["policy"] == pid][-1]
        out.append((f"hetero-{policy}", "hetero_place", "hetero_place",
                    *plugin_args("hetero_place", call)))
    out.append(("cp", "cp_place", "cp_place",
                *plugin_args("cp_place", MESH_BATCH_CALLS["cp_batch"][-1])))
    out.append(("gang", "cp_gang_place", "cp_gang_place_ids",
                *plugin_args("cp_gang_place_ids", MESH_BATCH_CALLS["gang_batch"][-1])))
    return out


def mesh_plugin_case(label, name, fn, args, statics, cfg, one, timed):
    """One pass under one mesh: the sharded call identical (uint32 views)
    to the one-device kernel, its launches and layouts (none gathered),
    the guarded call's seconds beside the execute deadline, and (``timed``)
    its ms over ``MESH_PLUGIN_TIMED`` calls (CUDA events: the step loop
    makes streams and events, which a graph does not capture) and µs a
    step or round."""
    from nomad_tpu_torch import backend
    from nomad_tpu_torch.resilience.breaker import breaker_for

    module = plugin_module(name)
    sharded = [a if ax is None else backend.shard_put(a, ax, cfg)
               for a, ax in zip(args, MESH_PLUGIN_AXES[fn])]
    call = lambda: getattr(module, fn)(*sharded, *statics)  # noqa: E731
    zero_counters()
    backend.reset_mesh_layouts()
    t0 = time.perf_counter()
    got = call()
    torch.cuda.synchronize()
    guarded_s = time.perf_counter() - t0
    launches = {k: v for k, v in counters().items() if v}
    layouts = backend.mesh_layouts()
    mesh = f"{cfg.dp}x{cfg.mp}"
    same_outputs(got, one, f"mesh {label} {mesh} against the one-device kernel")
    assert not any(k.endswith(":gathered") for k in layouts), (label, mesh, layouts)
    steps = launches[MESH_PLUGIN_MERGE[name]]
    guard = {"hetero_place": "hetero_place_kernel", "cp_place": "cp_place_kernel",
             "cp_gang_place": "cp_gang_place_kernel"}[name]
    out = {
        "mesh": [cfg.dp, cfg.mp], "identical": True, "steps_or_rounds": steps,
        "guarded_call_s": guarded_s, "execute_deadline_s": breaker_for(guard).execute_deadline,
        "launches": launches, "layouts": layouts,
    }
    if timed:
        out["ms"] = cuda_ms(call, iters=MESH_PLUGIN_TIMED, warmup=0)
        out["us_per_step"] = out["ms"] * 1e3 / max(steps, 1)
    return out


def mesh_plugin_passes(dev, devices, shapes=MESH_SHAPES):
    """(h) each pass at its batch path's shape: the one-device kernel
    (``plugin_ms``) and the plain version, then the sharded call under
    each mesh. hetero-maxmin, cp and gang are timed under every mesh;
    the makespan and cost policies are checked under 1x4."""
    out = {}
    for label, name, fn, args, statics in mesh_plugin_inputs():
        module = plugin_module(name)
        one = getattr(module, fn)(*args, *statics)
        plain = getattr(module, f"{fn}_plain")(*args, *statics)
        torch.cuda.synchronize()
        same_outputs(one, plain, f"mesh {label}: the one-device kernel")
        full = label in ("hetero-maxmin", "cp", "gang")
        g, n = args[4].shape
        res = {"shape": f"G={g} N={n} C={statics[-1]}", "unsharded_ms": plugin_ms(name, args, statics)}
        if full:
            bound, by, work = plugin_bound(name, args, statics, one)
            res.update(bound_ms=bound, bound_by=by, work=work,
                       plain_ms=cuda_ms(lambda: getattr(module, f"{fn}_plain")(*args, *statics),
                                        iters=1, warmup=0))
        res["meshes"] = {
            f"{dp}x{mp}": mesh_plugin_case(label, name, fn, args, statics,
                                           mesh_of(dp, mp, devices), one, full)
            for dp, mp in (shapes if full else shapes[:1])
        }
        log(f"[mesh] plugin {label}: " + json.dumps(res, sort_keys=True))
        out[label] = res
        del one, plain
    return out


def plugin_recipe(dev, kind, fleet, mesh=None):
    """The "hetero", "cp" or "gang" path's recipe through a Harness on
    ``dev`` (its passes laid out over ``mesh`` when one is given), on
    copies of ``fleet`` (the mixed fleet's nodes, or ``gang_fleet``'s
    nodes and ballast): the cp recipe on a fresh mixed fleet. Returns the
    live allocs as (job, group, node) counts and the host seconds of the
    evals."""
    from nomad_tpu_torch.scheduler import Harness
    from nomad_tpu_torch.state import SchedulerConfiguration

    h = Harness(device=dev, mesh=mesh)
    if kind == "gang":
        jobs, bad = gang_recipe(h, fleet=fleet)
        runs = [(None, jobs + [bad])]
    else:
        for node in fleet:
            h.store.upsert_node(h.next_index(), copy.deepcopy(node))
        if kind == "hetero":
            jobs = hetero_jobs()
            runs = [(f"hetero-{p}", jobs[i * HETERO_JOBS_PER_POLICY:(i + 1) * HETERO_JOBS_PER_POLICY])
                    for i, p in enumerate(HETERO_POLICIES)]
        else:
            jobs = cp_jobs()
            runs = [("cp-pack", jobs)]
        for job in jobs:
            h.store.upsert_job(h.next_index(), job)
    seconds = 0.0
    for algorithm, batch in runs:
        if algorithm is not None:
            h.store.set_scheduler_config(h.next_index(), SchedulerConfiguration(
                scheduler_algorithm=algorithm
            ))
        seconds += sum(run_evals(h, batch))
    placed = collections.Counter((a.job_id, a.task_group, a.node_id) for a in live(h, jobs))
    return placed, seconds


def mesh_plugin_recipes(dev, devices, shape=MESH_PLUGIN_RECIPES):
    """(i) the three recipes through their kernel objects, without the
    mesh and then under ``shape``: the placements identical; the launch
    counts of the sharded runs alone: every plugin pass a step or round
    loop of the mesh kernels ("shard" / "merge"), none gathered, none of
    the one-device auctions', no fallback. Returns (the counts, a
    summary)."""
    from nomad_tpu_torch import backend
    from nomad_tpu_torch.utils.metrics import global_metrics

    cfg = mesh_of(*shape, devices)
    kinds = ("hetero", "cp", "gang")
    mixed = mixed_fleet()
    fleets = {"hetero": mixed, "cp": mixed, "gang": gang_fleet()}
    want = {k: plugin_recipe(dev, k, fleets[k]) for k in kinds}
    fallback0 = global_metrics.snapshot()["counters"].get(FALLBACK_CALLS, 0)
    zero_counters()
    backend.reset_mesh_layouts()
    got = {k: plugin_recipe(dev, k, fleets[k], mesh=cfg) for k in kinds}
    launches = counters()
    layouts = backend.mesh_layouts()
    fallback = global_metrics.snapshot()["counters"].get(FALLBACK_CALLS, 0) - fallback0
    for k in kinds:
        assert got[k][0] == want[k][0], f"mesh {k} recipe: placements differ from the run without"
        assert sum(got[k][0].values()) > 0, f"mesh {k} recipe: nothing placed"
    assert all(launches[n] > 0 for n in MESH_PLUGIN), launches
    assert launches["cp_place"] == launches["cp_gang_place"] == 0, launches
    assert not any(k.endswith(":gathered") for k in layouts), layouts
    assert {f"{n}:{'merge' if 'merge' in n else 'shard'}" for n in MESH_PLUGIN} <= set(layouts)
    assert fallback == 0, fallback
    out = {
        "mesh": list(shape), "identical": True, "layouts": layouts, "fallback_calls": fallback,
        "allocs": {k: sum(got[k][0].values()) for k in kinds},
        "seconds": {k: got[k][1] for k in kinds},
        "unsharded_seconds": {k: want[k][1] for k in kinds},
    }
    log("[mesh] plugin recipes " + json.dumps(out, sort_keys=True))
    return launches, out


def mesh_plugin_kernel_checks(shape=MESH_PLUGIN_RECIPES):
    """(j) each mesh kernel of the hetero pass and the auctions alone, on
    (h)'s hetero-maxmin, cp and gang inputs cut into ``shape``'s node
    slices (groups row 0): every cell's first-step candidates, the
    lead's merge and every cell's apply or settle, each against its plain
    version on the same inputs (outputs identical); the claim also with
    the gang term. Each timed by graph replay (the plain versions by CUDA
    events) beside its bound: the inputs read once and the outputs
    written once over the memory rate, or (the shard step, the claim) its
    cells' f32 operations over the peak rate."""
    from nomad_tpu_torch.device import cp as C
    from nomad_tpu_torch.scheduler import hetero as H

    mp = shape[1]
    inputs = {label: (args, statics) for label, _, _, args, statics in mesh_plugin_inputs()}

    def cut(x, j, seg, axis):
        return x.narrow(axis, j * seg, seg).contiguous()

    # the hetero pass's first step
    args, (pid, _, max_c) = inputs["hetero-maxmin"]
    capacity, used0, asks, counts, eligible, tp, tpmax, cost = args
    g, n = tp.shape
    seg = n // mp
    dev = tp.device
    placed = torch.zeros(g, dtype=torch.int32, device=dev)
    cells = [(cut(capacity, j, seg, 0), cut(used0, j, seg, 0), asks, counts,
              cut(eligible, j, seg, 1), cut(tp, j, seg, 1), cut(cost, j, seg, 0), placed)
             for j in range(mp)]
    step = lambda fn: torch.cat([fn(*cells[j], pid, j * seg) for j in range(mp)])  # noqa: E731
    cand = step(H.hetero_shard_step)
    lead = (placed, torch.zeros(g, dtype=torch.float32, device=dev), counts, tpmax, asks,
            torch.full((g, max_c), -1, dtype=torch.int32, device=dev),
            torch.zeros((g, max_c), dtype=torch.float32, device=dev))
    merge = lambda fn: fn(cand, *lead, pid)  # noqa: E731
    record = merge(H.hetero_step_merge)[0]
    apply = lambda fn: [fn(record, cells[j][1], placed, j * seg, 0) for j in range(mp)]  # noqa: E731
    checks = {
        "hetero_shard_step": (lambda: step(H.hetero_shard_step),
                              lambda: step(H.hetero_shard_step_plain)),
        "hetero_step_merge": (lambda: merge(H.hetero_step_merge),
                              lambda: merge(H.hetero_step_merge_plain)),
        "hetero_shard_apply": (lambda: apply(H.hetero_shard_apply),
                               lambda: apply(H.hetero_shard_apply_plain)),
    }
    # (bytes read once and written once, f32 operations, launches)
    bounds = {
        "hetero_shard_step": (sum(nbytes(*c) for c in cells) + nbytes(cand),
                              g * n * HETERO_OPS_PER_CELL, mp),
        "hetero_step_merge": (nbytes(cand, *lead) + nbytes(record, *lead[:2], *lead[5:]), 0, 1),
        "hetero_shard_apply": (sum(nbytes(record, *c[1:2]) + nbytes(c[1], placed, placed)
                                   for c in cells), 0, mp),
    }
    shapes = {
        "hetero_shard_step": f"G={g} S={mp} cells x {seg} nodes (a call's first step: "
                             f"the cell's lists built, every head walked)",
        "hetero_step_merge": f"G={g} S={mp} columns, C={max_c}",
        "hetero_shard_apply": f"G={g} S={mp} cells x {seg} nodes",
    }

    # the auctions' first round, plain and with the gang term
    for label in ("cp", "gang"):
        args, (_, max_c) = inputs[label]
        (capacity, used0, asks, counts, eligible, scores, prio, job_counts, distinct,
         jobgrp) = args[:10]
        lam0 = args[-1]
        g, n = scores.shape
        seg = n // mp
        code, n_jobs = C._codes(jobgrp)
        job_code = code.to(torch.int32)
        gang = None
        if label == "gang":
            gid, w_rack, w_pod, w_ici, level_ids, widths = args[10:16]
            gcode, n_gangs = C._codes(torch.where(gid > 0, gid, 0))
            gang_code = torch.where(gid > 0, gcode, -1).to(torch.int32)
            tables = [torch.zeros((n_gangs, w), dtype=torch.int32, device=dev) for w in widths]
            gang = (gang_code, *[C._cp_topo_quant(w) for w in (w_rack, w_pod, w_ici)])
        zeros = dict(dtype=torch.int32, device=dev)
        state = [dict(used=cut(used0, j, seg, 0), lam=cut(lam0, j, seg, 0),
                      assigned=torch.zeros((g, seg), **zeros),
                      sib=torch.zeros((n_jobs, seg), **zeros), placed=torch.zeros(g, **zeros))
                 for j in range(mp)]
        parts = [(cut(capacity, j, seg, 0), state[j]["used"], asks, counts,
                  cut(eligible, j, seg, 1), cut(scores, j, seg, 1), cut(job_counts, j, seg, 1),
                  distinct, job_code, state[j]["lam"], state[j]["assigned"], state[j]["sib"],
                  state[j]["placed"]) for j in range(mp)]
        cell_gang = [None if gang is None else (*gang, cut(level_ids, j, seg, 1), *tables)
                     for j in range(mp)]
        claim = lambda fn, p=parts, cg=cell_gang, s=seg: torch.cat(  # noqa: E731
            [fn(*p[j], j * s, cg[j]) for j in range(mp)])
        cp_cand = claim(C.cp_shard_claim)
        cp_lead = (prio, asks, job_code, None if gang is None else gang[0],
                   torch.zeros(g, **zeros), torch.zeros(g, **zeros), torch.zeros((), **zeros),
                   torch.full((g, max_c), -1, **zeros),
                   torch.zeros((g, max_c), dtype=torch.float32, device=dev),
                   torch.zeros(C.cp_record_words(g), **zeros))
        cp_merge = lambda fn, c=cp_cand, lead_=cp_lead: fn(c, *lead_)  # noqa: E731
        cp_record = cp_merge(C.cp_round_merge)[0]
        settle = lambda fn, r=cp_record, st=state, s=seg, tb=(  # noqa: E731
            tables if gang is not None else []): [
            fn(r, st[j]["used"], st[j]["lam"], st[j]["assigned"], st[j]["sib"], st[j]["placed"],
               j * s, 0, *tb) for j in range(mp)]
        suffix = "" if label == "cp" else " (gang)"
        checks[f"cp_shard_claim{suffix}"] = (lambda f=claim: f(C.cp_shard_claim),
                                             lambda f=claim: f(C.cp_shard_claim_plain))
        checks[f"cp_round_merge{suffix}"] = (lambda f=cp_merge: f(C.cp_round_merge),
                                             lambda f=cp_merge: f(C.cp_round_merge_plain))
        checks[f"cp_shard_settle{suffix}"] = (lambda f=settle: f(C.cp_shard_settle),
                                              lambda f=settle: f(C.cp_shard_settle_plain))
        per_cell = CP_GANG_OPS_PER_CELL if gang is not None else CP_OPS_PER_CELL
        cell_bytes = nbytes(*parts[0]) + (0 if gang is None else nbytes(*cell_gang[0]))
        bounds[f"cp_shard_claim{suffix}"] = (mp * cell_bytes + nbytes(cp_cand),
                                              g * n * per_cell, mp)
        bounds[f"cp_round_merge{suffix}"] = (
            nbytes(cp_cand, *[x for x in cp_lead if x is not None]) + nbytes(*cp_lead[4:]), 0, 1)
        settle_bytes = sum(nbytes(st["used"], st["lam"], st["assigned"], st["placed"])
                           for st in state) * 2 + mp * nbytes(cp_record)
        bounds[f"cp_shard_settle{suffix}"] = (settle_bytes, 0, mp)
        shapes[f"cp_shard_claim{suffix}"] = f"G={g} S={mp} cells x {seg} nodes{suffix}"
        shapes[f"cp_round_merge{suffix}"] = f"G={g} S={mp} columns, C={max_c}{suffix}"
        shapes[f"cp_shard_settle{suffix}"] = f"G={g} S={mp} cells x {seg} nodes{suffix}"

    out = {}
    for name, (fn, plain) in checks.items():
        got, want = fn(), plain()
        torch.cuda.synchronize()
        flat = lambda x: [t for t in (x if isinstance(x, (list, tuple)) else [x])  # noqa: E731
                          for t in (t if isinstance(t, (list, tuple)) else [t])]
        same_outputs(flat(got), flat(want), f"mesh: {name}")
        b, o, launches = bounds[name]
        t_bytes = b / HBM_BYTES_PER_S * 1e3
        t_ops = o / F32_OPS_PER_S * 1e3
        out[name] = {
            "max_abs_err": 0.0, "choice_mismatches": 0,
            "ms": graph_ms(fn) / launches, "stream_ms": cuda_ms(fn) / launches,
            "plain_ms": cuda_ms(plain, iters=3, warmup=1) / launches,
            "bound_ms": max(t_bytes, t_ops) / launches,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "shape": shapes[name] + " (a launch)",
        }
        out[name]["plain_stream_ms"] = out[name]["plain_ms"]
    assert int(record[0]) == 0 and int(cp_record[1]) > 0, \
        "mesh: the checked step or round took nothing"
    log("[mesh] plugin kernels " + json.dumps(out, sort_keys=True))
    return out


def mesh_path(dev):
    """The "mesh" phase, (a) to (j); returns (the mesh path's launch
    counts, those of its spread recipe, those of its plugin recipes, the
    phase's summary)."""
    t0 = time.perf_counter()
    devices = mesh_devices(dev)
    out = {"card": card_line()}
    out["closed_form"] = mesh_closed_form(dev, devices)
    out["dryrun"] = mesh_dryrun(dev, devices)
    launches, calls, out["schedule"] = mesh_schedule(dev, devices)
    out["schedule"]["replayed"] = replay_mesh_calls(calls, mesh_of(*MESH_SCHEDULE, devices))
    del calls
    assert launches["closed_form_topk_merge"] > 0 and launches["place_closed_form"] > 0, launches
    out["chaos"] = mesh_chaos(dev, devices)
    out["coupled_scans"] = mesh_coupled_scans(dev, devices)
    spread_launches, spread_calls, out["spread"] = mesh_spread(dev, devices)
    out["coupled_kernels"] = mesh_kernel_checks(spread_calls)
    del spread_calls
    out["plugin_passes"] = mesh_plugin_passes(dev, devices)
    plugin_launches, out["plugin_recipes"] = mesh_plugin_recipes(dev, devices)
    out["plugin_kernels"] = mesh_plugin_kernel_checks()
    count = torch.cuda.device_count()
    if count > 1:
        distinct = [torch.device("cuda", i) for i in range(count)]
        n = 4 if count >= 4 else 2
        out["distinct_cards"] = {
            "cards": n,
            "closed_form": mesh_closed_form(dev, distinct, shapes=((1, n),)),
            "schedule": mesh_schedule(dev, distinct, shape=(1, n))[2],
            "coupled_scans": mesh_coupled_scans(dev, distinct, shapes=((1, n),)),
        }
        log(f"[mesh] distinct cards: {n} of {count} exercised")
    else:
        out["distinct_cards"] = None
        log("mesh: 1 card, shards share cuda:0; distinct-card half not exercised")
    out["seconds"] = time.perf_counter() - t0
    return launches, spread_launches, plugin_launches, out


def analysis_plain(call):
    """A recorded kernel call's plain version on the same inputs (a mesh
    carrier's inputs gathered onto its lead): the wrapper's module's
    ``<wrapper>_plain``, by the wrapper's argument names."""
    from nomad_tpu_torch import backend
    from nomad_tpu_torch.analysis.kernellint import import_fleet

    mod = sys.modules[import_fleet()[call.name].module]
    plain = getattr(mod, "component_scores" if call.wrapper == "score_matrix"
                    else f"{call.wrapper}_plain")
    bound = inspect.signature(getattr(mod, call.wrapper)).bind(*call.args, **call.kwargs)
    return plain(**{k: backend.gather(v) for k, v in bound.arguments.items()})


def outputs_err(got, want, what) -> float:
    """Integers and masks identical; floats at the same -inf places and
    within ``MAX_ABS_ERR`` elsewhere. Returns the largest float error."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want), what
    err = 0.0
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == w.dtype, (what, i, g.shape, w.shape)
        if g.dtype.is_floating_point:
            fin = torch.isfinite(w)
            assert torch.equal(fin, torch.isfinite(g)) and torch.equal(g[~fin], w[~fin]), (what, i)
            if fin.any():
                err = max(err, float((g[fin] - w[fin]).abs().max()))
        else:
            assert torch.equal(g, w), f"{what}: output {i} differs from plain"
    assert err <= MAX_ABS_ERR, f"{what}: {err} from plain"
    return err


def analysis_path(dev, calib) -> dict:
    """The "analysis" phase, (a) to (e); returns its summary."""
    from nomad_tpu_torch.analysis import retrace
    from nomad_tpu_torch.analysis.kernellint import (
        FLEET, exercise, fingerprint_table, import_fleet, rules,
    )
    from nomad_tpu_torch.analysis.kernellint.rules import outputs_equal
    from nomad_tpu_torch.api.http import HTTPAgent
    from nomad_tpu_torch.server import Server, ServerConfig

    t_phase = time.perf_counter()
    out = {"card": card_line()}
    # (a) the analysis CLI as a user runs it: both halves, on the card
    t0 = time.perf_counter()
    r = subprocess.run(
        [sys.executable, "-m", "nomad_tpu_torch.analysis", "--json"],
        capture_output=True, text=True, cwd=REPO_DIR, timeout=300,
    )
    assert r.returncode == 0, (r.returncode, r.stdout[-4000:], r.stderr[-4000:])
    cli = json.loads(r.stdout)
    baseline_path = os.path.join(REPO_DIR, "nomad_tpu_torch", "analysis", "baseline.json")
    with open(baseline_path) as f:
        ratcheted = [e["fingerprint"] for e in json.load(f)["entries"]]
    assert cli["source"]["new"] == [] and cli["source"]["fixed"] == [], cli["source"]
    assert len(ratcheted) == 28
    assert cli["kernels"]["new"] == [] and cli["kernels"]["analyzed"] == 21, cli["kernels"]
    out["cli"] = {
        "seconds": time.perf_counter() - t0,
        "source_new": 0, "ratcheted_fingerprints": len(ratcheted),
        "ratcheted_findings": cli["source"]["ratcheted"],
        "kernels_analyzed": cli["kernels"]["analyzed"],
        "kernel_configs": cli["kernels"]["configs"], "kernel_new": 0,
    }
    log(f"[analysis] cli {json.dumps(out['cli'], sort_keys=True)}")

    # (b) the fleet on the card, twice: launches, plain versions, bits, dtypes
    reg = import_fleet()
    zero_counters()
    t0 = time.perf_counter()
    first = exercise.exercise_fleet(dev)
    torch.cuda.synchronize()
    fleet_s = time.perf_counter() - t0
    launches = counters()
    launches["find_preemption"] += launches.pop(CARRIED)
    by_kernel = {name: launches[name.removesuffix("_kernel")] for name in FLEET}
    assert all(n >= 1 for n in by_kernel.values()), by_kernel
    second = exercise.exercise_fleet(dev)
    assert [c.name for c in first] == [c.name for c in second]
    errs, dtype_findings = {}, []
    for a, b in zip(first, second):
        assert outputs_equal(a.out, b.out), f"{a.name}: the second run differs"
        errs[a.name] = max(errs.get(a.name, 0.0),
                           outputs_err(a.out, analysis_plain(a), f"{a.name} ({a.wrapper})"))
    for name in FLEET:
        dtype_findings += rules.check_dtype_discipline(
            reg[name], [c for c in first + second if c.name == name]
        )
    assert dtype_findings == [], [f.render() for f in dtype_findings]
    out["fleet"] = {
        "seconds": fleet_s, "calls": len(first), "launches": by_kernel,
        "max_abs_err": errs, "second_run_identical": True, "dtype_findings": 0,
    }

    # (c) a third run inside the budget window: no build
    before = retrace.counts()
    with retrace.budget_window():
        exercise.exercise_fleet(dev)
    after = retrace.counts()
    window = {k: after.get(k, 0) - before.get(k, 0) for k in after}
    assert sum(window.values()) == 0, window
    out["builds"] = retrace.report()
    out["window_builds"] = sum(window.values())
    log(f"[analysis] builds against budgets {json.dumps(out['builds'], sort_keys=True)}; "
        f"in the budget window {out['window_builds']}")

    # (d) the API's fingerprints of the kernels this process launched
    server = Server(ServerConfig(num_workers=1, device=dev))
    http = HTTPAgent(server, None, port=0)
    http.start()
    try:
        import urllib.request

        with urllib.request.urlopen(f"{http.address}/v1/agent/trace", timeout=60) as resp:
            trace = json.loads(resp.read())
    finally:
        http.stop()
        server.shutdown()
    fps = trace["kernel_fingerprints"]
    assert set(fps) >= set(FLEET), sorted(fps)
    assert fps == fingerprint_table(launched_only=True)
    out["fingerprints"] = fps

    # (e) the calib path's builds beyond its declared run
    out["calib_added_retraces"] = calib["added_retraces"]
    assert calib["added_retraces"] == 0, calib
    out["seconds"] = time.perf_counter() - t_phase
    return out


def find_launches(by_path) -> dict:
    """The find pass's launches on each path: its own launches plus the
    passes carried in the choice's launch (each a launch of its device
    code: ``find_warp_pass`` runs inside ``choose_kernel<true>``)."""
    return {
        "launches": by_path["preempt"]["find_preemption"] + by_path["preempt"][CARRIED],
        "launches_by_path": {
            p: c["find_preemption"] + c[CARRIED] for p, c in by_path.items()
        },
        "launched_alone": by_path["preempt"]["find_preemption"],
        "carried_in_choice_launch": by_path["preempt"][CARRIED],
    }


def kernel_entry(name, route, source, replaces, path, by_path, main, extra):
    keys = ("max_abs_err", "choice_mismatches", "ms", "plain_ms", "bound_ms",
            "bound_by", "stream_ms", "plain_stream_ms", "shape")
    entry = {
        "name": name,
        "route": route,
        "source": source,
        "replaces": replaces,
        "path": path,
        "launches": by_path[path][name],
        "launches_by_path": {p: c[name] for p, c in by_path.items()},
        "library_ms": None,
    }
    entry.update({key: main[key] for key in keys})
    entry.update(extra)
    return entry


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False", file=sys.stderr)
        return 1
    # every path but the "mesh" phase runs unsharded, on a multi-card host
    # too (the phase builds its meshes explicitly); members and agents
    # started below inherit it
    os.environ["NOMAD_TPU_MESH"] = "off"
    from nomad_tpu_torch import backend
    from nomad_tpu_torch.device import score as S

    t_start = time.perf_counter()
    seconds_by_phase = {}
    t_mark = [t_start]

    def mark(name):
        """Log the seconds since the last mark, and the run's so far."""
        now = time.perf_counter()
        seconds_by_phase[name] = now - t_mark[0]
        t_mark[0] = now
        log(f"[time] {name} {seconds_by_phase[name]:.1f} s, {now - t_start:.1f} s in")

    dev = backend.resolve_device("cuda")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    card = card_line()
    log(card)

    # phase 1: builds
    t0 = time.perf_counter()
    libs = backend.build_all()
    log(
        f"[build] nvcc {sorted(p.name for p in libs.values())} in "
        f"{time.perf_counter() - t0:.3f} s"
    )
    mark("build")

    # phase 2: closed-form kernel at the headline shape and with extras
    ct = build_cluster(10_000, seed=42)
    asks = build_asks(ct, 100, 1000, seed=7)
    b, max_j, k = device_batch(ct, asks, dev)
    assert (ct.padded_n, max_j, k) == (16384, 80, 1024), (ct.padded_n, max_j, k)
    args = closed_form_args(b)
    cf = check_closed_form("headline", args, False, max_j, k, None, timed=True)
    ex_args, ex_j, ex_k, jitter = extras_case(dev)
    cf_ex = check_closed_form(
        "extras+spread+jitter", ex_args, True, ex_j, ex_k, jitter, timed=False
    )
    cf_sweep = closed_form_sweep(dev)

    # phase 3: score matrix, both variants
    t0 = time.perf_counter()
    sm_args, tp = score_matrix_inputs(b, dev)
    S.score_matrix(*sm_args, False, None)
    torch.cuda.synchronize()
    log(f"[build] triton score_matrix first launch {time.perf_counter() - t0:.3f} s")
    sm = check_score_matrix("plain", sm_args, False, None, timed=True)
    sm_tp = check_score_matrix("throughputs", sm_args, False, tp, timed=True)
    sm_g = score_matrix_by_g(sm_args, dev)
    sm_batch = cp_batch_scoring(dev)
    del b, args, ex_args, sm_args, tp

    # phase 4: small run, card against CPU
    cross_device_check(dev)
    mark("phases 2-4")

    # phase 5: the paths, counters zeroed just before each; then each
    # recorded kernel call against its plain version
    by_path, cf_calls, sm_calls = main_path(dev)
    cf_main = replay_closed_form(cf_calls)
    sm_main = replay_score_matrix(sm_calls)
    # what the server stands on: the incremental seam, the merged batch
    # pass and the dry-run plan, on the schedule path's recipe
    fleet = schedule_fleet()
    by_path["incremental"], incr = incremental_path(dev, *fleet)
    arm_launches, arm_calls, incr["kernel_arms"] = incremental_kernel_arms(dev)
    by_path.update(arm_launches)
    for path, rec in arm_calls.items():
        for name, calls in rec.items():
            if not calls:
                continue
            if name in COUPLED:
                r = replay_coupled(name, calls)
            else:
                r = replay_plugin(name, name, calls, path)
            incr["kernel_arms"][path].setdefault("replayed", {})[name] = {
                "calls": len(calls), "path_ms": r["path_ms"], "max_abs_err": r["max_abs_err"],
            }
    del arm_launches, arm_calls
    by_path["batch"], batch, batch_h = batch_path(dev, *fleet)
    by_path["plan"], plan = plan_path(dev, batch_h)
    del fleet, batch_h
    mark("schedule, incremental, batch, plan")
    by_path["server"], server_calls, server = server_path(dev)
    server_coupled = {
        name: replay_coupled(name, calls) for name, calls in server_calls.items() if calls
    }
    del server_calls
    mark("server")
    # the leader services under the same bench, and the defrag controller
    # planning with the migration kernel on the server's card
    by_path["leader"], leader_calls, leader_coupled_calls, leader = leader_path(dev)
    leader_migrate = replay_migrate(leader_calls, timed_label="leader cycle")
    leader["coupled_replayed"] = {}
    for name, calls in leader_coupled_calls.items():
        if calls:
            r = replay_coupled(name, calls)
            leader["coupled_replayed"][name] = {
                k: r[k] for k in ("path_ms", "max_abs_err", "choice_mismatches")
            }
    del leader_calls, leader_coupled_calls
    mark("leader")
    # the kernel guard under faults: chaos runs, the degraded slice, the
    # soak and the saturation search on the server's card
    resilience = resilience_path(dev)
    mark("resilience")
    # the dev agent's front door: ``agent -dev`` and the CLI as a user
    # runs them, then the HTTP API and the SDK at the server path's size
    agent_cli_out = agent_cli_path(dev)
    by_path["agent"], agent_calls, agent = agent_http_path(dev, server)
    agent["cli"] = agent_cli_out
    agent_coupled = {
        name: replay_coupled(name, calls) for name, calls in agent_calls.items() if calls
    }
    del agent_calls
    mark("agent")
    # the server cluster: three member processes on the card, a failover
    # and a restart; each leader's calls replayed in its own process
    cluster_launches, cluster_replays, cluster = cluster_path(dev, server)
    mark("cluster")
    # the client's out-of-process plugins: the card as a device, a probe
    # job on it, a task outliving its driver plugin, a CSI volume, and a
    # GPU fleet placed through device accounting
    by_path["plugins"], plugins = plugins_path(dev)
    mark("plugins")
    h, by_path["spread"], spread_calls, _ = spread_path(dev)
    coupled = {name: replay_coupled(name, spread_calls[name]) for name in COUPLED}
    del spread_calls
    by_path["wide_values"], wide_calls = wide_values_path(h)
    wide = {name: replay_coupled(name, wide_calls[name]) for name in COUPLED}
    del h, wide_calls
    h, by_path["preempt"], preempt_calls, _ = preempt_path(dev)
    preempt_main = {name: replay_preempt(name, preempt_calls[name]) for name in PREEMPT}
    del preempt_calls
    by_path["system"], system_calls, _ = system_path(h)
    sm_system = replay_score_matrix(system_calls, path="system")
    by_path["restore"], restore = restore_path(dev, h)
    del h
    h, by_path["hetero"], hetero_calls, _ = hetero_path(dev)
    by_path["cp"], cp_calls, _ = cp_path(h)
    del h
    by_path["gang"], gang_calls, _ = gang_path(dev)
    batch_by_path, batch_calls, _ = batch_paths(dev)
    by_path.update(batch_by_path)
    by_path["calib"], calib_calls, calib = calib_path(dev)
    calib_replay = replay_plugin("hetero_place", "hetero_place", calib_calls, "calib")
    del calib_calls
    plugin_main = {
        name: replay_plugin(name, fn, calls, path)
        for name, fn, calls, path in (
            ("hetero_place", "hetero_place", hetero_calls, "hetero"),
            ("cp_place", "cp_place", cp_calls, "cp"),
            ("cp_gang_place", "cp_gang_place_ids", gang_calls, "gang"),
        )
    }
    plugin_batch = {
        name: replay_plugin(name, fn, batch_calls[path], path)
        for name, fn, path in (
            ("hetero_place", "hetero_place", "hetero_batch"),
            ("cp_place", "cp_place", "cp_batch"),
            ("cp_gang_place", "cp_gang_place_ids", "gang_batch"),
        )
    }
    del hetero_calls, cp_calls, gang_calls, batch_calls
    by_path["defrag"], defrag_calls, _ = defrag_path(dev)
    migrate_main = replay_migrate(defrag_calls)
    del defrag_calls
    mark("spread to defrag")
    # the closed-form and score-matrix kernels' time on every path that
    # launches them
    one_by_one = SHARED_CALLS["incremental"]["place_closed_form"][:SERVER_JOBS]
    shared = {"place_closed_form": {}, "score_matrix": {}}
    for name, path, calls in (
        ("place_closed_form", "schedule", cf_calls),
        ("score_matrix", "score_group", sm_calls),
        ("score_matrix", "system", system_calls),
        *[(name, path, calls) for path, rec in SHARED_CALLS.items()
          for name, calls in rec.items()],
    ):
        assert len(calls) == by_path[path][name], (name, path, len(calls))
        if calls:
            shared[name][path] = replay_shared(name, calls, path)
    for name, by in shared.items():
        for path, counts in by_path.items():
            assert (counts[name] > 0) == (path in by), (name, path)
    SHARED_CALLS.clear()
    del cf_calls, sm_calls, system_calls
    plugins["closed_form"] = {
        k: shared["place_closed_form"]["plugins"][k] for k in ("calls", "path_ms", "shapes")}
    log(
        f"[plugins] device caps host ms per eval "
        f"{plugins['fleet']['device_caps_ms']['per_eval']!r} (the fleet's "
        f"{plugins['fleet']['eval_latency_ms']['evals']} evals) beside the closed form's "
        f"path_ms {plugins['closed_form']['path_ms']!r} over the path's "
        f"{plugins['closed_form']['calls']} calls"
    )
    # the cluster's calls were recorded and replayed in its member processes
    by_path["cluster"] = cluster_launches
    mark("shared replays")
    # the "mesh" phase: the closed form at 100,000 nodes under meshes on
    # the card, the score matrix, the dryrun's sizes, the schedule recipe
    # through Harness(mesh=1x4) (the path whose launches are counted) and
    # a chaos run with the process mesh; distinct cards where there are
    by_path["mesh"], by_path["mesh_spread"], by_path["mesh_plugins"], mesh = mesh_path(dev)
    log("[mesh] " + json.dumps(mesh, sort_keys=True))
    mark("mesh")
    batch.update(
        kernel_ms=shared["place_closed_form"]["batch"]["path_ms"],
        one_by_one_kernel_ms=calls_ms([shared_launch("place_closed_form", c) for c in one_by_one]),
        one_by_one_host_seconds=incr["arms"][0]["seconds"],
    )
    del one_by_one
    log("[server] " + json.dumps({
        "incremental": incr, "batch": batch, "plan": plan, "calib": calib, "leader": leader,
        "resilience": resilience, "agent": agent,
        "cluster": {k: cluster[k] for k in ("config", "leaders", "phases", "views", "eval_ms")},
        "plugins": {k: v for k, v in plugins.items() if k != "dev_node"},
        "restore": restore, "server": {
            k: server[k] for k in (
                "config", "card", "allocs_per_sec", "evals_per_sec", "eval_latency_ms",
                "elapsed_s", "path_seconds", "placed", "total", "unaccounted_allocs",
                "failed_evals", "committed_overcommit", "swallowed", "phase_breakdown_ms",
                "commit_train", "batch", "device_cache", "plan_apply_p99_ms",
                "invoke_scheduler_p99_ms",
            )
        },
    }, sort_keys=True))

    # phase 6: the coupled placements against the stepwise oracle
    full_parity(dev)
    mark("phase 6")

    # phase 7: the preemption kernels alone, both forms and a tied case
    preempt_phase = preempt_kernel_phase(dev)

    # phase 8: the plugin kernels alone, G 1 / 30 / 100 and a tied case
    plugin_phase = plugin_kernel_phase(dev)

    # phase 9: the migration auction alone, A up to 20,000, ties, budgets
    migrate_phase = migrate_kernel_phase(dev)

    # phase 10: the one-per-value kernel alone at the widths of its forms
    opv_phase = opv_kernel_phase(dev)

    # phase 11: the value scan and the chunked scan alone, cluster and
    # one-block forms
    cluster_phase = coupled_cluster_phase(dev)
    mark("phases 7-11")

    # the "analysis" phase: the analysis CLI on the card, the kernel
    # fleet twice against its plain versions and inside the build budget
    # window, and the API's kernel fingerprints
    analysis = analysis_path(dev, calib)
    log("[analysis] " + json.dumps(analysis, sort_keys=True))
    mark("analysis")

    def headline(r, shape):
        return {
            "ms": r["ms"], "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "stream_ms": r["stream_ms"],
            "plain_stream_ms": r["plain_stream_ms"], "shape": shape,
        }

    cf_main["max_abs_err"] = max(
        cf_main["max_abs_err"], cf["max_abs_err"], cf_ex["max_abs_err"]
    )
    cf_main["choice_mismatches"] += cf["choice_mismatches"] + cf_ex["choice_mismatches"]
    sm_main["max_abs_err"] = max(
        sm_main["max_abs_err"], sm["max_abs_err"], sm_tp["max_abs_err"],
        sm_system["max_abs_err"], *[r["max_abs_err"] for r in sm_g.values()],
    )
    sm_main["choice_mismatches"] += (
        sm["choice_mismatches"] + sm_tp["choice_mismatches"]
        + sm_system["choice_mismatches"] + sm_batch["choice_mismatches"]
        + sum(r["choice_mismatches"] for r in sm_g.values())
    )
    kernels = [
        kernel_entry(
            "place_closed_form", "cuda", "nomad_tpu_torch/csrc/closed_form.cu",
            "nomad_tpu/device/score.py:313", "schedule", by_path, cf_main,
            {
                "path_ms": shared["place_closed_form"]["schedule"]["path_ms"],
                "path_ms_by_path": {p: r["path_ms"] for p, r in shared["place_closed_form"].items()},
                "blocks_per_lane_by_path": {
                    p: r["blocks_per_lane"] for p, r in shared["place_closed_form"].items()
                },
                "headline": {
                    **headline(cf, "G=128 (100 real) N=16384 J=80 k=1024"),
                    "blocks_per_lane": cf["blocks_per_lane"],
                },
                "phase2_sweep": cf_sweep,
                "cluster": {
                    m: r["place_closed_form"] for m, r in cluster_replays.items()
                    if "place_closed_form" in r
                },
                "plugins": {**plugins["closed_form"],
                            "launches": by_path["plugins"]["place_closed_form"]},
            },
        ),
        kernel_entry(
            "score_matrix", "triton", "nomad_tpu_torch/device/score_triton.py",
            "nomad_tpu/device/score.py:914", "score_group", by_path, sm_main,
            {
                "path_ms": shared["score_matrix"]["score_group"]["path_ms"],
                "path_ms_by_path": {p: r["path_ms"] for p, r in shared["score_matrix"].items()},
                "headline": headline(sm, "G=128 N=16384"),
                "headline_throughputs": headline(sm_tp, "G=128 N=16384"),
                "by_groups": {f"G={g}": headline(r, f"G={g} N=16384") for g, r in sm_g.items()},
                "cp_batch_scoring": sm_batch,
                "system": headline(sm_system, sm_system["shape"]),
            },
        ),
    ] + [
        kernel_entry(
            name, "cuda", "nomad_tpu_torch/csrc/coupled.cu", replaces, "spread",
            by_path, coupled[name],
            {
                **{k: coupled[name][k] for k in (
                    "steps_per_launch", "us_per_step", "slots_per_step", "picks", "path_ms",
                    "blocks_per_lane",
                )},
                "wide_values": {k: wide[name][k] for k in (
                    "max_abs_err", "choice_mismatches", "ms", "plain_ms",
                    "bound_ms", "bound_by", "steps_per_launch", "us_per_step", "picks",
                    "shape", "path_ms", "blocks_per_lane",
                )},
                "kernel_phase": opv_phase if name == "place_spread_opv" else cluster_phase[name],
                **({"server": {k: server_coupled[name][k] for k in (
                    "path_ms", "max_abs_err", "choice_mismatches", "ms", "shape",
                )} | {"calls": by_path["server"][name]}} if name in server_coupled else {}),
                **({"agent": {k: agent_coupled[name][k] for k in (
                    "path_ms", "max_abs_err", "choice_mismatches", "ms", "shape",
                )} | {"calls": by_path["agent"][name]}} if name in agent_coupled else {}),
                "cluster": {m: r[name] for m, r in cluster_replays.items() if name in r},
            },
        )
        for name, replaces in (
            ("place_value_scan", "nomad_tpu/device/score.py:430"),
            ("place_spread_chunked", "nomad_tpu/device/score.py:545"),
            ("place_spread_opv", "nomad_tpu/device/score.py:690"),
        )
    ] + [
        kernel_entry(
            name, "cuda", "nomad_tpu_torch/csrc/preempt.cu", replaces, "preempt",
            by_path, preempt_main[name],
            {
                **{k: preempt_main[name][k] for k in (
                    "path_ms", "feasible_nodes", "victims", "choice_ms", "choice_path_ms",
                    "forms",
                ) if k in preempt_main[name]},
                **(find_launches(by_path) if name == "find_preemption" else {}),
                "kernel_phase": preempt_phase[name],
            },
        )
        for name, replaces in (
            ("find_preemption", "nomad_tpu/device/preempt.py:61"),
            ("choose_preemption_node", "nomad_tpu/device/preempt.py:116"),
        )
    ] + [
        kernel_entry(
            name, "cuda", source, replaces, path, by_path, plugin_main[name],
            {
                "path_ms": plugin_main[name]["path_ms"],
                "steps_or_rounds_per_launch": plugin_main[name]["steps_or_rounds_per_launch"],
                **({"path_us_per_step": plugin_main[name]["path_us_per_step"],
                    "calib": {k: calib_replay[k] for k in (
                        "ms", "plain_ms", "bound_ms", "bound_by", "path_ms", "shape",
                        "steps_or_rounds_per_launch", "path_us_per_step",
                    )}} if name == "hetero_place" else {}),
                "batch": {k: v for k, v in plugin_batch[name].items() if k in (
                    "ms", "plain_ms", "bound_ms", "bound_by", "path_ms", "shape",
                    "steps_or_rounds_per_launch", "path_us_per_step",
                )},
                "kernel_phase": plugin_phase[name],
            },
        )
        for name, source, replaces, path in (
            ("hetero_place", "nomad_tpu_torch/csrc/hetero.cu",
             "nomad_tpu/scheduler/hetero.py:157", "hetero"),
            ("cp_place", "nomad_tpu_torch/csrc/cp.cu", "nomad_tpu/device/cp.py:134", "cp"),
            ("cp_gang_place", "nomad_tpu_torch/csrc/cp.cu",
             "nomad_tpu/device/cp.py:360", "gang"),
        )
    ] + [
        kernel_entry(
            "migrate_plan", "cuda", "nomad_tpu_torch/csrc/migrate.cu",
            "nomad_tpu/device/migrate.py:85", "defrag", by_path, migrate_main,
            {
                **{k: migrate_main[k] for k in (
                    "path_ms", "rounds_per_launch", "rounds", "rounds_run", "moves",
                    "reference_dense_ms",
                )},
                "path_ms_by_path": {"defrag": migrate_main["path_ms"],
                                    "leader": leader_migrate["path_ms"]},
                "leader": {
                    **{k: leader_migrate[k] for k in (
                        "ms", "plain_ms", "bound_ms", "bound_by", "shape", "path_ms",
                        "rounds_per_launch", "rounds", "rounds_run", "moves",
                        "reference_dense_ms", "max_abs_err",
                    )},
                    "event_ms_by_cycle": [r["kernel_event_ms"] for r in leader["cycles"]],
                },
                "kernel_phase": migrate_phase,
            },
        )
    ]
    m14 = mesh["closed_form"]["meshes"]["1x4"]
    kernels.append(kernel_entry(
        "closed_form_topk_merge", "cuda", "nomad_tpu_torch/csrc/closed_form.cu",
        "nomad_tpu/device/score.py:104", "mesh", by_path,
        {
            "max_abs_err": 0.0, "choice_mismatches": m14["merge_mismatches"],
            "ms": m14["merge_ms"], "plain_ms": m14["plain_merge_ms"],
            "bound_ms": m14["merge_bound_ms"], "bound_by": m14["merge_bound_by"],
            "stream_ms": m14["merge_stream_ms"], "plain_stream_ms": m14["plain_merge_stream_ms"],
            "shape": f"G=128 S=4 k'={m14['k_local']} k={m14['k']} "
                     f"({m14['nodes_per_shard']} nodes a shard)",
        },
        {
            "by_mesh": {
                name: {k: r[k] for k in (
                    "merge_ms", "merge_bound_ms", "shards_ms", "shards_bound_ms",
                    "call_ms", "shard_forms",
                ) if k in r}
                for name, r in mesh["closed_form"]["meshes"].items()
            },
            "unsharded": mesh["closed_form"]["unsharded"],
            "schedule": {k: mesh["schedule"][k] for k in ("seconds", "unsharded_seconds",
                                                         "layouts", "calls")},
        },
    ))
    mk, scans = mesh["coupled_kernels"], mesh["coupled_scans"]
    for name, replaces in (
        ("coupled_shard_step", "nomad_tpu/device/score.py:642"),
        ("coupled_step_merge", "nomad_tpu/device/score.py:104"),
        ("coupled_shard_apply", "nomad_tpu/device/score.py:647"),
    ):
        kernels.append(kernel_entry(
            name, "cuda", "nomad_tpu_torch/csrc/coupled.cu", replaces, "mesh_spread", by_path,
            mk[name],
            {
                "spread": {k: mesh["spread"][k] for k in ("seconds", "unsharded_seconds",
                                                          "layouts", "opv_calls",
                                                          "chunked_calls")},
                "chunked_step": mk["chunked_step"],
                "scans": {
                    scan: {
                        "unsharded_ms": r["unsharded_ms"], "bound_ms": r["bound_ms"],
                        "steps": r["steps"], "shape": r["shape"],
                        "by_mesh": {m: {k: c[k] for k in ("ms", "us_per_step", "launches")}
                                    for m, c in r["meshes"].items()},
                    }
                    for scan, r in scans.items()
                },
            },
        ))
    pk, passes, recipes = mesh["plugin_kernels"], mesh["plugin_passes"], mesh["plugin_recipes"]
    for name, source, replaces, labels in (
        ("hetero_shard_step", "nomad_tpu_torch/csrc/hetero.cu",
         "nomad_tpu/scheduler/hetero.py:183", ("hetero-maxmin",)),
        ("hetero_step_merge", "nomad_tpu_torch/csrc/hetero.cu",
         "nomad_tpu/scheduler/hetero.py:180", ("hetero-maxmin",)),
        ("hetero_shard_apply", "nomad_tpu_torch/csrc/hetero.cu",
         "nomad_tpu/scheduler/hetero.py:186", ("hetero-maxmin",)),
        ("cp_shard_claim", "nomad_tpu_torch/csrc/cp.cu", "nomad_tpu/device/cp.py:115",
         ("cp", "gang")),
        ("cp_round_merge", "nomad_tpu_torch/csrc/cp.cu", "nomad_tpu/device/cp.py:171",
         ("cp", "gang")),
        ("cp_shard_settle", "nomad_tpu_torch/csrc/cp.cu", "nomad_tpu/device/cp.py:178",
         ("cp", "gang")),
    ):
        kernels.append(kernel_entry(
            name, "cuda", source, replaces, "mesh_plugins", by_path, pk[name],
            {
                **({"gang": pk[f"{name} (gang)"]} if f"{name} (gang)" in pk else {}),
                "recipes": {k: recipes[k] for k in ("seconds", "unsharded_seconds", "layouts")},
                "passes": {
                    label: {
                        "unsharded_ms": passes[label]["unsharded_ms"],
                        "bound_ms": passes[label]["bound_ms"],
                        "plain_ms": passes[label]["plain_ms"],
                        "shape": passes[label]["shape"],
                        "by_mesh": {m: {k: c[k] for k in (
                            "ms", "us_per_step", "steps_or_rounds", "guarded_call_s",
                            "launches",
                        )} for m, c in passes[label]["meshes"].items()},
                    }
                    for label in labels
                },
            },
        ))
    assert len(kernels) == 21, len(kernels)
    log(f"[total] {time.perf_counter() - t_start:.1f} s, builds included; by phase "
        + json.dumps({k: round(v, 1) for k, v in seconds_by_phase.items()}))
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(
        json.dumps(
            {
                "ok": True,
                "device": {
                    "platform": "gpu",
                    "kind": torch.cuda.get_device_name(0),
                    "count": torch.cuda.device_count(),
                },
            }
        ),
        flush=True,
    )
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--cluster-member"]:
        sys.exit(cluster_member(sys.argv[1:]))
    sys.exit(main())
