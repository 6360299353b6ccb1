#!/usr/bin/env python3
"""Chip smoke for the PyTorch/CUDA port (pinot_tpu_torch) on one NVIDIA card.

Run from the repository root, with no arguments:  python3 chip_smoke.py

Phases, in order; any failure raises and the process exits non-zero:
  1. device   - CUDA present; the card's name and power limit; TF32 off.
  2. build    - ops/csrc/*.cu compiled with nvcc for sm_90a into
                build/torch_kernels/ (first use) and loaded.
  3. kernels  - every kernel held EXACTLY against its plain PyTorch version on
                CUDA tensors: the CPU tests' grid, every instantiation (the
                two specialised ones, the generic one, the global-atomic
                path), unaligned
                views, shared and distinct masks, E = 16 and 17, G = 1 and
                8, out-of-table codes; then 9 shapes timed with CUDA events
                (median of 20 calls, L2 flushed before each): the
                distributed main path's launch (2^27 rows, packed 16-bit
                key, mask_words, an all-true entry mask, 2406 groups, count
                + int_sum), the segment main path's (2^23 rows, one mask),
                query (c)'s raw computed key (550 groups), G = 8, G = 8192
                with 4 sums (global path), and the distributed FILTER launch
                of query (e) (2^27 rows, packed key, mask_words, two
                distinct masks, count + two int32 sums), the MV explode
                of phase 4f (2^25 element rows, int32 key, G = 300) and the
                outer launch of phase 4g's IN (SELECT ...) (2^23 rows,
                packed 4-bit key, G = 11, the generic instantiation) and
                phase 4h's (z1) launch (2^27 rows, the computed int32 key
                of 7 groups, one mask, count + int32 sum).  Each:
                the wrapper call,
                the plain version, and one torch.Tensor.index_add_ per entry
                as the library yardstick (never called by the port).  Also
                printed: ptxas's registers/shared memory/spills of each
                instantiation and the atomic instructions in the SASS.
                Then the member axis: a grid of vmapped calls (stacked and
                shared keys, masks, values, words and code ranges, both
                specialised instantiations and the generic one, ragged
                tails, no common aligned head, two entry chunks, two member
                chunks, groups of 4 and 1, the global path), each EXACT
                against the plain version member by member with its
                launches' "W/Wg" layouts counted; then five shapes of W = 8
                members, each one torch.func.vmap of the wrapper (one
                member-axis launch, counted, its layout asserted) held
                EXACTLY against the plain version member by member: the
                segment batch of phase 4j (q2) (2^23 rows, the shared
                packed key and revenue, 8 row masks of lo_quantity <
                18..25), the same filter as 8 members' mask_words, at 2^27
                rows 8 code ranges lo_discount [k, k + 3) and, as (q4)
                launches it, 8 row masks (all four one group of 8), and
                (q2)'s rows with three entries (two groups of 4); each
                timed (the vmapped call, 8 unbatched calls, the plain
                version 8 times, and one index_add_ an entry into W x G
                cells keyed by key + G * member as the yardstick) beside
                its bound (shared streams once, each member's once, the
                tables).
  4. main path - SSB lineorder, --segments x --rows-per-segment rows (default
                8 x 2^23 = 67,108,864, just above SSB scale factor 10) from
                --seed, registered in QueryEngine() on CUDA; three queries
                checked EXACTLY against numpy golden results, with the
                kernels' launch counts read around that one run; then each
                query's warm median wall time over 5 runs and a profile.
 4b. dist_main_path - bench.py main()'s table: 2^27 = 134,217,728 rows from
                --seed in StackedTable.build(num_shards=1) with a range index
                on lo_quantity, queried through DistributedEngine() on CUDA
                at one launch and at three (launch_bytes 384 MiB): (a) the
                bench query (word-fused: the range-index words go to the
                fused scan as mask_words), (b) a two-predicate scalar
                aggregation, (c) a dense group-by with MIN/MAX (the words
                unpacked), (d) a sparse group-by over 1,323,300 keys with
                the device merge.  Every result EXACTLY equal to a numpy
                golden at both batchings, the route of each query checked
                from the counters around one counted run per engine; the
                20-literal sweep plans once; warm medians of 5 ((d): one
                run, cut from two for the script's limit), the host ms of
                the words and their copy, then a profile of each query but
                (d) (cut from both batchings for the script's limit).
 4c. transform_path - on the tables of phases 4 and 4b (no second build):
                (e) a FILTER (WHERE ...) group-by, (f) SSB Q1.1's
                SUM(lo_revenue * lo_discount), (g) a GROUP BY MOD(...) key
                with a CASE sum, (h) a top-100 selection, on both engines
                (the distributed one at one launch and at three); (i) an
                expression selection with OFFSET and (j) RANK / SUM OVER
                windows on the segment engine only (the distributed engine
                refuses them, as the JAX package's does).  Each query once
                counted (scan launches by instantiation, with mask_words, and
                the distinct masks of each launch) and held against a numpy
                golden, (e) and (g) required to launch the fused scan; then
                warm medians of 5.  The profiles of phases 4-4c run after all
                their wall timings; then one transform_path line per query
                and engine: wall, device busy and idle share, launches,
                masks, bytes of doc ids copied home, exact.
 4e. sketch_path (runs between 4c and 4d) - on the same tables: the funnel
                kernel held exactly against its plain version at 2^20 rows
                (S = 3 and 4); then (k) BASELINE config 3 (DISTINCTCOUNTHLL
                and PERCENTILETDIGEST beside COUNT/SUM on the fused scan),
                (l) DISTINCTCOUNT / HLL / PERCENTILEKLL / MODE, (m) theta,
                COVAR_POP, CORR, EXPR_MAX, LASTWITHTIME and HISTOGRAM by
                lo_discount, (n) the ordered funnel (the funnel kernel, one
                launch a segment or engine launch) on both engines, and (o)
                the sparse (d) group-by with DISTINCTCOUNTHLL(lo_revenue, 5)
                on the distributed engine; each counted once and held
                against a numpy golden (sketch fields equal, float
                statistics to rtol 1e-9), then warm medians (of 5; (m) of
                3 and (o) one run, cut for the script's limit) and a profile
                (but (o): cut for the limit);
                then the funnel kernel at four shapes (the 2^20-row check's,
                one segment's rows: the segment engine's launch, (n)'s on
                the stacked table, and skewed keys at the kernel's tile
                edges with runs above the cap), each exact against its
                plain version and timed: the wrapper call, the kernels'
                device time, the byte bound, the plain version, prepare and
                the whole function (prepare + scan) with its device time;
                last one key of 2^20 rows (the sequential walk) against a
                scalar loop.
 4d. storage  - on the same tables: the segment engine's 8 segments saved
                (segment/store.py format) into a directory under build/,
                loaded with verify=True (CRC) into a fresh QueryEngine()
                whose table schema adds a nullable INT column, (a), (b),
                (c), (e) exact against the goldens and the in-memory engine,
                (a) launching the scan once a segment, the added column
                read as NULL; write and load seconds, first-run and warm
                ms; the directory removed.  Then the residency sweep on
                phase 4b's table at ~16 launches: the working set W of
                (a) and (c) with an unbounded budget, an untiered engine
                (hbm_cache_bytes=0) and legs at 0.5x, 1x and 4x (budgets
                2W, W + 64 KiB, W/4), each exact, (a) launching with
                mask_words in every launch; per leg warm medians, rows/s,
                prefetch hits, stalls, hit rate, stall ms, evictions, and
                the peak allocated bytes against the budget; the 4x leg
                profiled once (the streams of the HtoD copies and of the
                scan, pinned or pageable, busy as the union of device
                events, idle share) and raced by an evictor; last, phase
                4b's engines (default residency) against untiered engines
                at the same launch budgets, in turns.
 4f. index_path (after 4d) - an MV table of 4 x 2^22 rows (STRING and INT
                MV columns) on both engines: ANY filters, the *MV
                aggregations, ARRAYLENGTH, and on the segment engine the
                GROUP BY explode (the fused scan, once a segment) and
                UNNEST, the distributed engine refusing those as the JAX one
                does; BASELINE config 4: 8 segments built by build_segment
                from phase 4's arrays with a star-tree, each query against
                its useStarTree=false twin; TEXT_MATCH / JSON_MATCH over 4 x
                2^20 rows; VECTOR_SIMILARITY over 2^20 x 384 float32.  Every
                result against a numpy golden, then warm medians.
                Profiles (phases 4-4j) run last: in each session the query
                runs once unmeasured, then once inside a record_function
                range whose device events are summed; the segment main
                path's queries (phase 4) take up to two sessions, every
                other phase's one session each (the script's time limit;
                phase 4b's cut from two).
 4g. front_door (after 4f) - on the tables of phases 4 and 4b: (y1)
                GAPFILL with FILL_PREVIOUS_VALUE and with the null fill
                over the 2406 days (a tenth of them filtered out), (y2)
                IN / NOT IN (SELECT the top 100 days by revenue), (y3)
                UNION ALL / UNION / INTERSECT / EXCEPT of two group-bys,
                (y4) EXPLAIN PLAN FOR config 2 (no launch, no doc) and
                EXPLAIN ANALYZE (the operator rows measured, Roofline_Pct
                at most 100), (y5) config 2 traced (8 launch and collect
                spans, one device_wait, reduce; plan, run, reduce on the
                distributed engine), (y6) a timeseries pipeline (891
                groups of a computed key, summed over tags, scaled);
                y1, y5, y6 on the distributed engine too, which refuses
                y2-y4 (ROADMAP Queue 3).  Each answer exact against numpy
                and its fused-scan launches counted; (y7) a 1 ms deadline
                raises QueryTimeoutError, a 1 MiB accountant refuses config
                2 before any launch, and the accountant is back to 0 bytes
                after every query; DDL through engine.sql, a ResponseStore
                paging (y1)'s rows and the slow-query log; warm medians of
                5, then one front_door line per query and engine.
 4h. join_path (after 4g) - the multi-stage join engine through
                DistributedEngine() on CUDA over phase 4b's 2^27-row
                lineorder (not rebuilt) and dimensions of SSB's DATE shape
                (dates: 2556 days of 1992-1998 keyed as lo_orderdate is;
                years: 7 rows; dates_early: the 1827 days of 1992-1996):
                (z1) BASELINE config 5 (GROUP BY d_year, broadcast), (z2)
                the same as a hash shuffle, (z3) SSB Q1.1 as a join, (z4)
                a dimension string x a fact column (55 groups), (z5) a
                LEFT JOIN with its NULL group, (z6) a snowflake chain, (z7)
                a top-100 join selection; then over a 2^24-row table built
                from phase 4's first two segments (z8) a many-to-many join
                against promo (3 rows a discount) and (z9) (z2) at
                shuffleSlack 0.01 (the overflow retries, exact) and with
                shuffleSlackCap 0.01 (the cap's RuntimeError).  Each exact
                against numpy with its fused-scan launches counted (one,
                i32/i32/shared, for each dense group-by; none for (z3) and
                (z7)) and its peak allocated bytes; warm medians of 5, one
                profile session each, one join_path line per query.
 4i. realtime_path (after 4h) - realtime tables (pinot_tpu_torch/realtime/)
                through QueryEngine.attach_realtime: (r1) phase 4's 8
                offline segments (not rebuilt) with a realtime part of one
                partition fed 2^20 + 2^19 rows through InMemoryStream at
                the default 2^20 rows a segment (one sealed segment saved
                under build/, one consuming snapshot of 2^19 rows), config
                2 exact over all rows with 8 + 1 + 1 launches; (r2) 20
                cycles of publish 4096 rows -> consume -> config 2, each
                exact with the new rows, the ms from publish to a visible
                answer, the snapshot rebuild and the allocation after each
                cycle (gate: cycle 20 at most one snapshot's device bytes +
                64 MiB above cycle 1); (r3) FULL upsert (lo_orderkey the
                primary key, ts the comparison column) over 2 partitions by
                partition_of, 2^21 + 2^18 messages over 2^20 keys: one
                sealed 2^20-row segment and a consuming snapshot a
                partition, config 2 exact against the latest row a key, 4
                launches whose plans carry the validDocIds mask; (r4) a
                fresh manager over (r3)'s directory (segments loaded with
                verify, the upsert bootstrap, the tail re-consumed), the
                same answer; (r5) StackedTable.from_segments over (r4)'s
                segments (compacted) in DistributedEngine(), exact in one
                launch.  One realtime_path line an item (ingest rows/s,
                seal s, snapshot ms, wall, device busy and idle share from
                one profile an engine, launches by instantiation, recovery
                s, peak allocated bytes).
 4j. batch_path (after 4i) - cross-query batching on the tables of phases 4
                and 4b (no new table): (q1) ServerInstance("s0") on CUDA
                serving phase 4's 8 segments, config 2 through execute exact
                against numpy, one traced call's device_wait and deviceMs;
                (q2) execute_batch of the 8 members lo_quantity < 18..25,
                each exact and equal to its own execute, in 8 member-axis
                launches (one a segment, each one group of 8) against 64
                for the 8 executes;
                (q3) the same batch with one member's deadline expired (it
                detaches, 7 exact); (q4) DistributedEngine().execute_many
                over phase 4b's table: 8 members lo_discount BETWEEN k AND
                k + 2 in 1 batched launch with dist.batchFallbacks
                unchanged, and 8 config-2 members (range-index words are
                row-sharded: not eligible) one launch each, all exact;
                (q5) three malformed queries raising PlanCheckError on the
                segment, distributed and multi-stage engines with 0
                launches; (q6) the named plan caches' entries, hits and
                misses.  Warm medians of the batches against their
                members one by one; one profile session each.
 4k. cluster_path (after 4j) - the cluster's control plane and router
                (pinot_tpu_torch/cluster/) on the tables of phase 4 (no new
                table): (k1) Coordinator(replication=2) with three
                ServerInstances on CUDA over phase 4's 8 segments and
                Broker(coord).query(config 2), exact, 8 fused-scan launches
                (p16/i32/shared) and no other, its warm median of 9 beside
                ServerInstance.execute's over the same segments in turns
                (one server with the same budget and residency; the
                difference is the broker's host ms) and (q1)'s, a traced
                call's plan / prune / server_execute spans; (k2) the replica the
                next query routes to first crashes on that call (FaultPlan):
                the query fails over, exact in 8 launches, the breaker
                records the failure, and restart_server heals it; (k3)
                query_many of (q2)'s 8 members: each exact, 8 member-axis
                launches of one group of 8; (k4) at reduced depth (phase 4's
                first 2 segments, 2^24 rows) a durable Coordinator
                (meta_dir, deep store under build/) on a simulated clock
                behind a CoordinatorHandle: add_segment uploads, a crashed
                server restarts from the deep store (CRC-verified), the
                lease expires and a hot standby promotes while the broker
                keeps serving, a fourth server joins and rebalance moves
                segments while a second thread queries; config 2 exact at
                every step; (k5) through the broker UNION ALL, IN (SELECT
                ...), EXPLAIN and EXPLAIN ANALYZE of phase 4g, each exact
                against its numpy golden and equal to the segment engine's
                answer.  Launches counted an item; hedge_drain() at the end.
 4l. serving_path (after 4k) - the serving surface over phase 4k's
                coordinator and broker (phase 4's 8 segments at full width):
                (l1) QueryServer(broker) on 127.0.0.1 queried through
                PinotClient: config 2 over HTTP exact in 8 launches, its
                warm median of 9 in turns with Broker.query; a top-100
                selection paged through a cursor, equal to the segment
                engine's rows; /metrics (Prometheus text federating the three
                servers, and JSON) and the five /debug views; a malformed
                query (400, no launch), an expired timeoutMs (408), a table
                quota (429) and both replicas of a segment failing (503
                NO_REPLICA_AVAILABLE); eight concurrent clients, each exact;
                (l2) the CLI: create-segment from a lineorder CSV of 2^22
                rows (cut from a segment's 2^23 for the script's limit; the
                parse timed inside the command), its columns equal to
                build_segment's over the same arrays; query on the card (no
                --device), exact in 1 launch; serve as a child process over
                that segment, queried over HTTP and stopped with SIGINT (exit
                0, the kernel library not rebuilt); slow-queries, admission,
                election, autopilot and perf against (l1)'s server; perf
                --check passing and failing over records under build/;
                quickstart; (l3) a coordinator-owned realtime table of 2^21 +
                2^19 rows at 2^20 rows a segment, RealtimeToOffline of its
                two sealed segments, MergeRollupTask and PurgeTask
                (lo_quantity = 50) on the offline table, config 2 and the
                counts exact after each; (l4) a materialized view of (day,
                quantity) with COUNT and SUM(lo_revenue) over phase 4's table:
                config 2 rewritten onto it exact, its wall in turns with the
                source's; a ninth segment (2^20 rows) stales it, the query
                falls back exact, a refresh repairs it (the ninth segment is
                then taken out again); (l5) config 2 through
                ServerInstance.execute on (q1)'s bare server and on phase 4k's
                coordinator-registered one, 9 runs each in turns.  One
                serving_path line an item; launches counted an item.
 4m. mesh_path (after 4l) - the engines over a mesh of device positions
                (pinot_tpu_torch/parallel/mesh.py): four positions of
                cuda:0 on one card (the cards in turn where there are
                several; the mesh_setup line says which), phase 4b's
                2^27-row table cut into 4 shards (StackedTable.resharded,
                views of the same arrays: no new table).  (m1) config 2 on a
                1-D DistributedEngine(mesh=) at one macro-batch and at three,
                4 fused-scan launches a macro-batch; (m2) query (c) (MIN /
                MAX) exact, and a float AVG within MESH_AVG_RTOL of numpy and
                of the one-position engine; (m3) config 2 on the 2x2 mesh
                (capacity mode); (m4) a ReplicatedEngine of 2 rows of 2
                positions over the table cut into 2 shards: 8 config-2
                queries round-robin, each exact, 2 launches each, the rows'
                residency managers distinct; (m5) (z1) broadcast and (z2)
                shuffle through the multi-stage engine on the 1-D mesh
                (dates built with 4 shards), exact against phase 4h's
                one-position engine, the shuffle's overflow retries and plans
                counted.  Config 2 against numpy and the one-position engine
                of phase 4b.  One mesh_path line an item: its launches, its
                warm median in turns with the one-position engine (5 runs
                each) and its device busy and idle share (one profile
                session an item, run with the other phases' profiles).
 4n. analysis_path (after 4m) - the port's analysis tools: (n1) `python -m
                pinot_tpu_torch.tools.cli lint --json` in a subprocess
                (started first, beside (n2) and (n3)): exit 0, no finding,
                the baseline live with no stale entry, the model-check sweep
                ok, its wall time; (n2) `cli mc --mutations --json` at the
                tier-1 budget (25 schedules): every model clean, every
                mutation caught, one caught trace saved and replayed bit for
                bit; (n3) config 2 warm, twice each through phase 4's
                QueryEngine, phase 4b's DistributedEngine and phase 4j's
                ServerInstance.execute (trace off) under
                torch.cuda.set_sync_debug_mode("warn"), each exact: one
                analysis_path line a synchronizing call site of the port
                (file:line, syncs a query by engine) with the static
                auditor's verdict (a finding, a baseline entry, an inline
                suppression, the allowlisted fence, the sanitizer: an
                explicit .cpu() drain, or nothing: a gap).
                Fails on an inexact result, a gate, or a sync debug mode
                that cannot be set; the fused-scan launches of (n3) count
                as analysis_path.
 4o. surface (after 4n) - the port's public surface on the tables of
                phases 4 and 4b (no new table): (o1) a device UDF
                registered through query/scalar.register_device_function
                (a torch clamp of lo_revenue) in SUM(CLAMPREV(lo_revenue))
                of a config-2 shaped group-by on phase 4b's
                DistributedEngine and phase 4's QueryEngine, exact against
                numpy, launching the fused scan; (o2) a dict UDF registered
                with string_result_fn=True in a GROUP BY and a WHERE on
                both engines, exact; (o3) `cli create-segment` from a
                schema file Schema.to_json wrote and a 2^16-row CSV, then
                `cli query --device cuda` (config 2), exact in 1 launch;
                (o4) DistributedEngine.device_batches over config 2's plan
                at one macro-batch and at three: as many batches as the
                plan has, on the card, each position's column and param
                shapes those _run staged for the same query.  One
                surface_path line an item; launches counted an item.
  5. profile  - after the main paths (a profiler session leaves tracing set
                up in the process): each timed shape's kernel device time
                (scan_ms, torch.profiler); at the segment main path's and
                query (c)'s shapes the same for the generic instantiation; at
                the segment main path's shape, after a write flush and after
                a read flush, scan_ms beside a float32 sum and a device copy
                of the same input bytes; each shape's launch_ms (CUDA events
                around a bare launch of the library); each member-axis
                shape's scan_ms and launch_ms (a bare launch of the vmap
                rule's own ScanBatch; the flush's share of it is
                member_phases.py's); and the code-range shape asserted
                under half of 8 x the distributed main path's launch.
  6. summary  - one {"kernels": [...]} JSON line (fused_scan, funnel_scan; launches_by_path
                includes front_door, join_path, realtime_path, batch_path,
                cluster_path, serving_path, mesh_path, analysis_path and
                surface; the
                member-axis launches by instantiation and by layout, and each
                member-axis shape with its Wg; flush_ms names
                member_phases.py, which measures it), the card's
                nvidia-smi line, and last the {"ok": true, "device": {...}} line.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import signal
import statistics
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, and the non-tensor-core
# rate used for the scan's integer adds (no integer rate is published)
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12
# CUDA-event-timed launches per kernel measurement, after warm-up
TIMED_ITERS = 20
# profiled launches per scan_ms measurement
PROFILED_ITERS = 10
# least share of a bare launch's CUDA-event time that a profiler session's
# median launch may take: sessions that caught every launch have read
# 0.86-1.0 of it, and one read every event at 0.43 (0.018 against 0.043 ms)
SESSION_FLOOR = 0.7

CONFIG2 = (
    "SELECT lo_orderdate, SUM(lo_revenue), COUNT(*) FROM lineorder "
    "WHERE lo_quantity < 25 GROUP BY lo_orderdate LIMIT 2500"
)
QUERY_B = (
    "SELECT SUM(lo_revenue), COUNT(*) FROM lineorder "
    "WHERE lo_discount BETWEEN 1 AND 3 AND lo_quantity < 25"
)
QUERY_C = (
    "SELECT lo_discount, lo_quantity, COUNT(*), SUM(lo_revenue), MIN(lo_revenue), MAX(lo_revenue) "
    "FROM lineorder GROUP BY lo_discount, lo_quantity ORDER BY SUM(lo_revenue) DESC LIMIT 10"
)


def log(phase: str, **kv) -> None:
    print(json.dumps({"phase": phase, **kv}), flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# phase 3: kernel vs plain version
# ---------------------------------------------------------------------------
def _pack(codes: np.ndarray, bits: int) -> np.ndarray:
    f = 32 // bits
    pad = (-len(codes)) % f
    lanes = np.concatenate([codes.astype(np.uint32), np.zeros(pad, np.uint32)]).reshape(-1, f)
    return np.bitwise_or.reduce(lanes << (np.arange(f, dtype=np.uint32) * np.uint32(bits)), axis=1).astype(np.uint32)


def _variants(rng):
    """(label, entries, codes, num_groups, kwargs) in numpy; entries are
    (kind, values, mask, limb_plan).  kwargs may hold "offsets": the element
    offset at which each kind of operand ("key", "mask", "values") starts
    inside a larger buffer, so that the kernel sees unaligned views."""
    def entries(n, kinds=("count", "i8", "i32", "i64"), shared_mask=False):
        one = rng.random(n) < 0.8
        m = (lambda: one) if shared_mask else (lambda: rng.random(n) < 0.8)  # noqa: E731
        make = {
            "count": lambda: ("count", None, m(), None),
            "i8": lambda: ("int_sum", rng.integers(-120, 120, n).astype(np.int8), m(), (1, True)),
            "i16": lambda: ("int_sum", rng.integers(-30000, 30000, n).astype(np.int16), m(), (2, True)),
            "u16": lambda: ("int_sum", rng.integers(0, 65536, n).astype(np.uint16), m(), (2, False)),
            "i32": lambda: ("int_sum", rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32), m(), (4, True)),
            "i64": lambda: ("int64_sum", rng.integers(-(2**39), 2**39, n).astype(np.int64), m(), None),
            "i64p5": lambda: ("int64_sum", rng.integers(-(2**39), 2**39, n).astype(np.int64), m(), 5),
            "u32": lambda: ("int_sum", rng.integers(0, 2**32, n, dtype=np.uint64).astype(np.uint32), m(), None),
        }
        return [make[k]() for k in kinds]

    def words(n):
        return np.packbits((rng.random(n) < 0.5).reshape(-1, 32), axis=1, bitorder="little").view(np.uint32).reshape(-1)

    out = []
    for n in (32, 4096, 4096 * 2 + 32, 1000):
        for g in (1, 7, 300):
            out.append((f"grid n={n} G={g}", entries(n), rng.integers(0, g, n).astype(np.int32), g, {}))
    n = 4096 * 3 + 32
    codes = rng.integers(0, 50, n).astype(np.int32)
    out.append(("mask_words+code_pred", entries(n), codes, 50,
                {"mask_words": words(n), "code_pred": (codes.astype(np.uint8), 10, 40)}))
    for bits in (4, 8, 16):
        n = 4096 + 32
        g = min(1 << bits, 300)
        c = rng.integers(0, g, n).astype(np.int32)
        out.append((f"packed {bits}-bit key", entries(n), c, g, {"codes_packed": (_pack(c, bits), bits)}))
    out.append(("uint32 int_sum, default plan", entries(1000, ("count", "u32")),
                rng.integers(0, 7, 1000).astype(np.int32), 7, {}))
    out.append(("G=8192, 3 entries (shared-memory limit)", entries(1 << 20, ("count", "i8", "i32")),
                rng.integers(0, 8192, 1 << 20).astype(np.int32), 8192, {}))
    out.append(("G=8192, count + 3 sums (224 KB of shared tables)", entries(1 << 20),
                rng.integers(0, 8192, 1 << 20).astype(np.int32), 8192, {}))
    out.append(("G=8192, 4 sums (global-atomic path)", entries(1 << 20, ("i8", "i32", "i64", "i16")),
                rng.integers(0, 8192, 1 << 20).astype(np.int32), 8192, {}))

    # every instantiation: key mode x value mode, with negative and >= G
    # codes where the key can hold them, on row counts that leave a tail
    # after the vector tiles (packed keys need whole words)
    value_sets = {"i32": ("count", "i32", "u32"), "i64": ("count", "i64", "i64p5"),
                  "any": ("count", "i8", "i16", "u16", "i32", "i64")}
    n_raw, n_packed = 512 * 5 + 37, 512 * 5 + 48
    for vm, kinds in value_sets.items():
        c = rng.integers(-3, 303, n_raw).astype(np.int32)
        out.append((f"int32 key, {vm} values, codes in [-3, 303) of G=300", entries(n_raw, kinds), c, 300, {}))
        c = np.where(rng.random(n_raw) < 0.9, rng.integers(0, 300, n_raw),
                     rng.integers(-(2**40), 2**40, n_raw)).astype(np.int64)
        out.append((f"int64 key (generic), {vm} values, wide codes", entries(n_raw, kinds), c, 300, {}))
        for bits in (4, 8, 16):
            g = {4: 12, 8: 200, 16: 2406}[bits]
            c = rng.integers(0, min(1 << bits, g + 40), n_packed).astype(np.int32)  # lanes >= G drop
            out.append((f"packed {bits}-bit key, {vm} values, G={g}", entries(n_packed, kinds), c, g,
                        {"codes_packed": (_pack(c, bits), bits)}))
    c = rng.integers(-128, 128, n_raw).astype(np.int8)
    out.append(("int8 key (generic), negative codes", entries(n_raw, ("count", "i32")), c, 100, {}))
    c = rng.integers(0, 4, n_packed).astype(np.int32)
    out.append(("packed 2-bit key (generic)", entries(n_packed, ("count", "i32")), c, 3,
                {"codes_packed": (_pack(c, 2), 2)}))

    # unaligned views, masks shared or not, chunked entry lists, hot slots
    n = 512 * 4 + 64
    c = rng.integers(0, 300, n).astype(np.int32)
    out.append(("views at offset 1 (common aligned head), mask_words+code_pred",
                entries(n, ("count", "i8", "i32", "i64")), c, 300,
                {"offsets": {"key": 1, "mask": 1, "values": 1}, "mask_words": words(n),
                 "code_pred": (c.astype(np.int16), 20, 250)}))
    for off in ((1, 2, 3), (3, 1, 2), (2, 3, 1)):
        out.append((f"views at offsets key/mask/values {off} (no common head: scalar loads)",
                    entries(n + 13, ("count", "i32", "i64")), rng.integers(0, 300, n + 13).astype(np.int32), 300,
                    {"offsets": dict(zip(("key", "mask", "values"), off))}))
    c = rng.integers(0, 2406, n).astype(np.int32)
    out.append(("packed 16-bit key, views at offsets 1 word / 2 / 2 (head of 2 rows)", entries(n, ("count", "i32")),
                c, 2406, {"codes_packed": (_pack(c, 16), 16), "offsets": {"key": 1, "mask": 2, "values": 2}}))
    out.append(("one mask shared by 4 entries", entries(n, ("count", "i8", "i32", "i64"), shared_mask=True),
                rng.integers(0, 300, n).astype(np.int32), 300, {}))
    out.append(("E=16 (one launch)", entries(n, ("count", "i32", "i64", "i8") * 4),
                rng.integers(0, 50, n).astype(np.int32), 50, {}))
    out.append(("E=17 (two launches)", entries(n, ("count", "i32", "i64", "i8") * 4 + ("count",)),
                rng.integers(0, 50, n).astype(np.int32), 50, {}))
    for g in (1, 8):
        out.append((f"G={g} hot slots, n=2^20", entries(1 << 20, ("count", "i32"), shared_mask=True),
                    rng.integers(0, g, 1 << 20).astype(np.int32), g, {}))
    return out


def _to_cuda(entries, codes, kwargs, dev):
    """CUDA copies; a numpy array used twice (a shared mask) stays one
    tensor, and kwargs["offsets"] places operands inside larger buffers."""
    offsets = kwargs.get("offsets", {})
    memo = {}  # id -> (array, tensor): the array stays alive, so ids stay unique

    def t(a, kind):
        if id(a) not in memo:
            off = offsets.get(kind, 0)
            buf = torch.zeros(len(a) + off, dtype=torch.from_numpy(a[:0]).dtype, device=dev)
            buf[off:] = torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            memo[id(a)] = (a, buf[off:])
        return memo[id(a)][1]

    ents = [(k, None if v is None else t(v, "values"), t(m, "mask"), lp) for k, v, m, lp in entries]
    kw = {}
    if "mask_words" in kwargs:
        kw["mask_words"] = torch.from_numpy(kwargs["mask_words"].view(np.int32)).to(dev)
    if "code_pred" in kwargs:
        pc, lo, hi = kwargs["code_pred"]
        kw["code_pred"] = (t(pc, "pred"), lo, hi)
    if "codes_packed" in kwargs:
        w, bits = kwargs["codes_packed"]
        kw["codes_packed"] = (t(w.view(np.int32), "key"), bits)
    return ents, t(codes, "key"), kw


def _max_abs_err(got, ref) -> float:
    return max(float((a - b).abs().max()) for a, b in zip(got, ref)) if got else 0.0


def _flushes(dev):
    """Two ways to evict the L2 cache before a timed call: a 256 MiB write
    (the default; it leaves the L2 full of dirty lines, which the next
    kernel's reads first write back) and a 256 MiB read (clean lines)."""
    buf = torch.zeros(64 << 20, dtype=torch.float32, device=dev)
    return {"write": buf.zero_, "read": buf.sum}


def _time_cuda(fn, flush, iters: int = TIMED_ITERS) -> float:
    """Median ms of `iters` calls (TIMED_ITERS unless said), each bracketed
    by its own CUDA events, with flush() called before each (a write flush,
    unless said)."""
    for _ in range(3 if iters >= TIMED_ITERS else 1):
        fn()
    times = []
    for _ in range(iters):
        flush()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _device_ms(fn, flush, kernel: str, launch_ms: float, launches: int = 1):
    """Median device ms of one launch of the kernels whose name holds
    `kernel`, each launch's own device event, over PROFILED_ITERS calls
    (`launches` launches each) under torch.profiler (flush() before each).
    A session counts when it captured every launch once, each with a
    positive duration (a session can lose events), and its median is at
    least SESSION_FLOOR of launch_ms, the CUDA-event time of one bare launch
    of the same kernel (a session can also report every event at about
    half its length); up to three sessions, else "not measured".  Each
    session's capture is logged (kernel_events)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    want, seen = PROFILED_ITERS * launches, []
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(PROFILED_ITERS):
                flush()
                fn()
            torch.cuda.synchronize()
        ms = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
              if e.device_type == DeviceType.CUDA and kernel in e.name]
        good = [m for m in ms if m > 0.0]
        seen.append({"captured": len(ms), "positive": len(good), "min_ms": min(ms, default=None),
                     "median_ms": statistics.median(ms) if ms else None, "max_ms": max(ms, default=None),
                     "names": sorted({e.name[:60] for e in prof.events() if kernel in e.name})})
        seen[-1]["floor_ms"] = SESSION_FLOOR * launch_ms
        if len(ms) == want and len(good) == want and statistics.median(good) >= SESSION_FLOOR * launch_ms:
            log("kernel_events", kernel=kernel, want=want, sessions=seen)
            return statistics.median(good)
    log("kernel_events", kernel=kernel, want=want, sessions=seen)
    return "not measured"


def _bare_launch(ents, key, g, kw, generic: bool = False):
    """One shape's launch straight through the library, its parameters
    built once (no wrapper host work between CUDA events; no counter
    moves), with the key and value modes set to "any" when `generic`:
    (zero-argument launch, its int64 [E, G] tables, the entry order)."""
    import ctypes

    from pinot_tpu_torch.ops import fused_scan

    lib = fused_scan._library()
    key_t, bits = kw["codes_packed"] if "codes_packed" in kw else (key, 0)
    p, order, _variant = fused_scan.build_params(
        ents, key_t, bits, int(ents[0][2].shape[0]), g, kw.get("mask_words"), kw.get("code_pred"),
        fused_scan._smem_optin(lib, torch.cuda.current_device()))
    if generic:
        p.key_mode = p.val_mode = 0
    out = torch.zeros((len(ents), g), dtype=torch.int64, device=key_t.device)

    def launch():
        err = lib.pinot_fused_scan(ctypes.byref(p), out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"fused scan launch failed: {lib.pinot_cuda_error_string(err).decode()}")
    return launch, out, order


def _effective_masks(ents, kw):
    """Each entry's mask ANDed with the filter words where the call has them
    (the rows the entry really counts)."""
    from pinot_tpu_torch.ops import fused_scan

    if "mask_words" not in kw:
        return [m for _k, _v, m, _lp in ents]
    words = fused_scan.lane_unpack(kw["mask_words"], 1, int(ents[0][2].shape[0])) != 0
    return [m & words for _k, _v, m, _lp in ents]


def _bound(ents, key_in, g, kw):
    """Least time for the same work: each input byte read once (the key,
    the filter words, each distinct mask, the values where their row is
    counted), each table written once; one 64-bit add per counted row and
    entry.  bound_ms_no_true_mask leaves out the bytes of masks that are
    all true (a kernel told "all rows" would not read them)."""
    masks = list({m.data_ptr(): m for _k, _v, m, _lp in ents}.values())
    counted = [int(m.sum()) for m in _effective_masks(ents, kw)]
    words = kw["mask_words"].numel() * 4 if "mask_words" in kw else 0
    read_bytes = key_in.numel() * key_in.element_size() + words + sum(m.numel() for m in masks) + sum(
        c * v.element_size() for (_k, v, _m, _lp), c in zip(ents, counted) if v is not None)
    true_mask_bytes = sum(m.numel() for m in masks if bool(m.all()))
    write_bytes = len(ents) * g * 8
    bytes_ms = (read_bytes + write_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = sum(counted) / SCALAR_OPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes_moved": read_bytes + write_bytes,
            "bound_ms_no_true_mask": max((read_bytes - true_mask_bytes + write_bytes) / HBM_BYTES_PER_S * 1e3,
                                         ops_ms)}


def _key_input(ents, key, kw):
    """The key tensor the kernel reads, and its codes as int64."""
    from pinot_tpu_torch.ops import fused_scan

    if "codes_packed" in kw:
        words, bits = kw["codes_packed"]
        return words, fused_scan.lane_unpack(words, bits, int(ents[0][2].shape[0])).to(torch.int64)
    return key, key.to(torch.int64)


def _timed_shape(label, ents, key, g, kw, flush):
    """kernel_ms (the wrapper call), plain_ms, library_ms (one index_add_ per
    entry on pre-masked int64 values, never called by the port), all with
    CUDA events; host_ms (the host time of a wrapper call, from the idle
    device to its return) and the bound."""
    from pinot_tpu_torch.ops import fused_scan

    before = dict(fused_scan.VARIANT_LAUNCHES)
    kernel_ms = _time_cuda(lambda: fused_scan.fused_group_tables(ents, key, g, **kw), flush)
    variants = sorted(k for k, v in fused_scan.VARIANT_LAUNCHES.items() if v != before.get(k, 0))
    host = []
    for _ in range(TIMED_ITERS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fused_scan.fused_group_tables(ents, key, g, **kw)
        host.append((time.perf_counter() - t0) * 1e3)
    host_ms = statistics.median(host)
    plain_ms = _time_cuda(lambda: fused_scan.fused_group_tables_reference(ents, key, g, **kw), flush)
    key_in, key64 = _key_input(ents, key, kw)
    zero = torch.zeros((), dtype=torch.int64, device=key64.device)
    adds = [torch.where(m, m.to(torch.int64) if k == "count" else fused_scan._entry_values(k, v, lp), zero)
            for (k, v, _m, lp), m in zip(ents, _effective_masks(ents, kw))]

    def library():
        for a in adds:
            torch.zeros(g, dtype=torch.int64, device=key64.device).index_add_(0, key64, a)

    library_ms = _time_cuda(library, flush)
    timing = {"shape": label, "variant": variants, "kernel_ms": kernel_ms, "host_ms": host_ms, "plain_ms": plain_ms,
              "library_ms": library_ms, **_bound(ents, key_in, g, kw)}
    log("kernel_timing", iters=TIMED_ITERS, bound_divisor=f"{HBM_BYTES_PER_S:.3g} B/s (H100 SXM HBM3 peak)", **timing)
    if not (kernel_ms <= library_ms):
        raise AssertionError(f"fused scan slower than its index_add_ yardstick at {label}: {timing}")
    return timing


def _timed_shapes(seed: int, dev):
    """The 9 timed shapes, each held exactly against the plain version and
    timed with CUDA events."""
    from pinot_tpu_torch.ops import fused_scan

    worst, timings = 0.0, []
    flush = _flushes(dev)["write"]
    for label, ents, key, g, kw in _shapes(seed, dev):
        got = fused_scan.fused_group_tables(ents, key, g, **kw)
        ref = fused_scan.fused_group_tables_reference(ents, key, g, **kw)
        err = _max_abs_err(got, ref)
        worst = max(worst, err)
        log("kernel_check", variant=label, max_abs_err=err)
        if err != 0.0:
            raise AssertionError(f"fused scan differs from its plain version at {label}: {err}")
        timings.append(_timed_shape(label, ents, key, g, kw, flush))
    return worst, timings


# ---------------------------------------------------------------------------
# phase 3, the member axis: the fused scan under torch.func.vmap
# ---------------------------------------------------------------------------
# members of one batched launch in phases 3 and 4j (batch_width()'s default),
# and the rows of the segment and the distributed member-axis shapes
BATCH_W = 8
MEMBER_SEG_ROWS = 1 << 23
MEMBER_DIST_ROWS = 1 << 27


def _member_shapes(seed: int, dev):
    """The member-axis shapes, on the card, made from the seed: (label, W,
    G, members, batched, layout).  members(w) gives member w's unbatched
    (entries, key, kwargs); batched() makes the one vmapped wrapper call
    that the main path's batched closures make (one member-axis launch);
    layout is that launch's "W/Wg" (fused_scan.BATCH_LAYOUTS: W members,
    Wg of them a block)."""
    from pinot_tpu_torch.ops import fused_scan, segmented

    rng = np.random.default_rng(seed)
    W, g = BATCH_W, 2406
    plan = segmented.sum_limb_plan(100, 999_999)
    ks = torch.arange(18, 18 + W)  # lo_quantity < k, k = 18..25
    out = []
    # the segment main path's batch (q2): one segment of 2^23 rows, the
    # packed lo_orderdate key and int32 revenue shared; each member's row
    # mask of lo_quantity < k (the range-index words the segment filter
    # unpacks); then the same filter handed over as each member's words
    n = MEMBER_SEG_ROWS
    words = torch.from_numpy(_pack(rng.integers(0, g, n).astype(np.int32), 16).view(np.int32)).to(dev)
    rev = torch.from_numpy(rng.integers(100, 1_000_000, n).astype(np.int32)).to(dev)
    qty = torch.from_numpy(rng.integers(1, 51, n).astype(np.int32)).to(dev)
    masks = torch.stack([qty < k for k in ks.tolist()])
    qwords = torch.stack([torch.from_numpy(np.packbits(
        (qty < k).cpu().numpy().reshape(-1, 32), axis=1, bitorder="little").view(np.int32).reshape(-1)).to(dev)
        for k in ks.tolist()])
    ones = torch.ones(n, dtype=torch.bool, device=dev)

    def seg_member(w):
        return [("count", None, masks[w], None), ("int_sum", rev, masks[w], plan)], None, \
            {"codes_packed": (words, 16)}

    def seg_batched():
        return torch.func.vmap(lambda m: fused_scan.fused_group_tables(
            [("count", None, m, None), ("int_sum", rev, m, plan)], None, g, codes_packed=(words, 16)))(masks)

    def segw_member(w):
        return [("count", None, ones, None), ("int_sum", rev, ones, plan)], None, \
            {"codes_packed": (words, 16), "mask_words": qwords[w]}

    def segw_batched():
        return torch.func.vmap(lambda mw: fused_scan.fused_group_tables(
            [("count", None, ones, None), ("int_sum", rev, ones, plan)], None, g, codes_packed=(words, 16),
            mask_words=mw))(qwords)

    rows = f"n=2^{n.bit_length() - 1} packed16 G=2406 E=2, W=8"
    out.append((f"segment batch (q2): {rows} row masks lo_quantity < 18..25, key and values shared",
                W, g, seg_member, seg_batched, "8/8"))
    out.append((f"segment batch, words: {rows} mask_words lo_quantity < 18..25, all-true mask shared",
                W, g, segw_member, segw_batched, "8/8"))
    # the distributed launch (q4): 2^27 rows, lo_orderdate packed and
    # revenue shared, lo_discount BETWEEN k AND k + 2 for k = 0..7: each
    # member's code range [k, k + 3) over the shared discount codes, then
    # as the closure hands it over, each member's row mask
    n2 = MEMBER_DIST_ROWS
    words2 = torch.from_numpy(_pack(rng.integers(0, g, n2).astype(np.int32), 16).view(np.int32)).to(dev)
    rev2 = torch.from_numpy(rng.integers(100, 1_000_000, n2).astype(np.int32)).to(dev)
    disc = torch.from_numpy(rng.integers(0, 11, n2).astype(np.uint8)).to(dev)
    ones2 = torch.ones(n2, dtype=torch.bool, device=dev)
    los = torch.arange(W, dtype=torch.int64)
    dmasks = torch.stack([(disc >= k) & (disc <= k + 2) for k in range(W)])

    def pred_member(w):
        return [("count", None, ones2, None), ("int_sum", rev2, ones2, plan)], None, \
            {"codes_packed": (words2, 16), "code_pred": (disc, w, w + 3)}

    def pred_batched():
        return torch.func.vmap(lambda lo: fused_scan.fused_group_tables(
            [("count", None, ones2, None), ("int_sum", rev2, ones2, plan)], None, g, codes_packed=(words2, 16),
            code_pred=(disc, lo, lo + 3)))(los)

    def dmask_member(w):
        return [("count", None, dmasks[w], None), ("int_sum", rev2, dmasks[w], plan)], None, \
            {"codes_packed": (words2, 16)}

    def dmask_batched():
        return torch.func.vmap(lambda m: fused_scan.fused_group_tables(
            [("count", None, m, None), ("int_sum", rev2, m, plan)], None, g, codes_packed=(words2, 16)))(dmasks)

    rows2 = f"n=2^{n2.bit_length() - 1} packed16 G=2406 E=2, W=8"
    out.append((f"dist batch: {rows2} code ranges lo_discount [k, k+3) k=0..7, all-true mask shared",
                W, g, pred_member, pred_batched, "8/8"))
    out.append((f"dist batch (q4): {rows2} row masks lo_discount BETWEEN k AND k+2, key and values shared",
                W, g, dmask_member, dmask_batched, "8/8"))
    # three entries (COUNT(*), SUM(lo_revenue), SUM(lo_quantity)) over the
    # segment batch's rows: 5 x 2406 table words a member, so a block holds
    # 4 members' tables and the 8 members run as two groups of 4
    qplan = segmented.sum_limb_plan(1, 50)

    def seg3_member(w):
        return [("count", None, masks[w], None), ("int_sum", rev, masks[w], plan),
                ("int_sum", qty, masks[w], qplan)], None, {"codes_packed": (words, 16)}

    def seg3_batched():
        return torch.func.vmap(lambda m: fused_scan.fused_group_tables(
            [("count", None, m, None), ("int_sum", rev, m, plan), ("int_sum", qty, m, qplan)], None, g,
            codes_packed=(words, 16)))(masks)

    out.append((f"segment batch, three entries: n=2^{n.bit_length() - 1} packed16 G=2406 E=3, W=8, row masks "
                "lo_quantity < 18..25, key, revenue and quantity shared (two groups of 4)",
                W, g, seg3_member, seg3_batched, "8/4"))
    return out


def _member_bound(W, g, members):
    """Least time for a member-axis launch: every distinct input stream
    read once (a shared operand once for all members, a stacked one once a
    member; shared values at the rows any member counts), the W tables
    written once; one 64-bit add per counted row, entry and member."""
    streams, counted_rows = {}, 0
    value_rows = {}
    for w in range(W):
        ents, key, kw = members(w)
        key_in, _ = _key_input(ents, key, kw)
        streams[key_in.data_ptr()] = key_in.numel() * key_in.element_size()
        if "mask_words" in kw:
            streams[kw["mask_words"].data_ptr()] = kw["mask_words"].numel() * 4
        eff = _effective_masks(ents, kw)
        if "code_pred" in kw:
            pc, lo, hi = kw["code_pred"]
            streams[pc.data_ptr()] = pc.numel() * pc.element_size()
            eff = [m & (pc >= lo) & (pc < hi) for m in eff]
        for (_k, v, m, _lp), e in zip(ents, eff):
            streams[m.data_ptr()] = m.numel()
            counted_rows += int(e.sum())
            if v is not None:
                prev = value_rows.get(v.data_ptr(), (None, v.element_size()))[0]
                value_rows[v.data_ptr()] = (e if prev is None else prev | e, v.element_size())
    read_bytes = sum(streams.values()) + sum(int(m.sum()) * size for m, size in value_rows.values())
    write_bytes = W * len(members(0)[0]) * g * 8
    bytes_ms = (read_bytes + write_bytes) / HBM_BYTES_PER_S * 1e3
    ops_ms = counted_rows / SCALAR_OPS_PER_S * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms), "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "bytes_moved": read_bytes + write_bytes, "adds": counted_rows}


def _member_library(W, g, members):
    """The yardstick: one index_add_ per entry into W x G int64 cells keyed
    by key + G * member, over the members' counted rows (made before the
    clock starts); never called by the port."""
    from pinot_tpu_torch.ops import fused_scan

    idx, adds = [], None
    for w in range(W):
        ents, key, kw = members(w)
        _key_in, key64 = _key_input(ents, key, kw)
        eff = _effective_masks(ents, kw)
        if "code_pred" in kw:
            pc, lo, hi = kw["code_pred"]
            eff = [m & (pc >= lo) & (pc < hi) for m in eff]
        rows = eff[0]  # every entry of these shapes shares one mask
        idx.append(key64[rows] + g * w)
        vals = [torch.ones_like(idx[-1]) if k == "count" else fused_scan._entry_values(k, v, lp)[rows]
                for k, v, _m, lp in ents]
        adds = [[a] for a in vals] if adds is None else [acc + [a] for acc, a in zip(adds, vals)]
    idx = torch.cat(idx)
    adds = [torch.cat(a) for a in adds]
    dev = idx.device

    def library():
        for a in adds:
            torch.zeros(W * g, dtype=torch.int64, device=dev).index_add_(0, idx, a)

    return library


def _timed_member_shapes(shapes, dev):
    """Each member-axis shape (_member_shapes): the vmapped wrapper call
    once, counted (one launch, W members) and held EXACTLY against the
    plain version member by member; then kernel_ms (the vmapped call),
    w_sequential_ms (W unbatched wrapper calls on the same inputs),
    plain_ms (the plain version W times, one run: 1.3 s at 2^27 rows),
    library_ms, all with CUDA events; and the bound."""
    from pinot_tpu_torch.ops import fused_scan

    worst, timings = 0.0, []
    flush = _flushes(dev)["write"]
    for label, W, g, members, batched, layout in shapes:
        before = (fused_scan.LAUNCHES, dict(fused_scan.BATCH_LAUNCHES), fused_scan.BATCH_MEMBERS,
                  dict(fused_scan.BATCH_LAYOUTS))
        got = batched()
        torch.cuda.synchronize()
        launches = fused_scan.LAUNCHES - before[0]
        variants = {k: v - before[1].get(k, 0) for k, v in fused_scan.BATCH_LAUNCHES.items()
                    if v != before[1].get(k, 0)}
        layouts = {k: v - before[3].get(k, 0) for k, v in fused_scan.BATCH_LAYOUTS.items()
                   if v != before[3].get(k, 0)}
        if launches != 1 or sum(variants.values()) != 1 or fused_scan.BATCH_MEMBERS - before[2] != W:
            raise AssertionError(f"{label}: {launches} launches {variants}, want one member-axis launch of {W}")
        if layouts != {layout: 1}:
            raise AssertionError(f"{label}: member-axis layouts {layouts}, want one launch of {layout} (W/Wg)")
        err = 0.0
        for w in range(W):
            ents, key, kw = members(w)
            ref = fused_scan.fused_group_tables_reference(ents, key, g, **kw)
            err = max(err, _max_abs_err([t[w] for t in got], ref))
        worst = max(worst, err)
        log("kernel_check", variant=label, max_abs_err=err, launches=launches, member_axis=variants,
            layout=layout)
        if err != 0.0:
            raise AssertionError(f"the member-axis scan differs from its plain version at {label}: {err}")

        def sequential():
            for w in range(W):
                ents, key, kw = members(w)
                fused_scan.fused_group_tables(ents, key, g, **kw)

        def plain():
            for w in range(W):
                ents, key, kw = members(w)
                fused_scan.fused_group_tables_reference(ents, key, g, **kw)

        kernel_ms = _time_cuda(batched, flush)
        w_sequential_ms = _time_cuda(sequential, flush)
        plain_ms = _time_cuda(plain, flush, iters=1)
        library = _member_library(W, g, members)
        library_ms = _time_cuda(library, flush, iters=5)
        del library
        timing = {"shape": label, "members": W, "layout": layout, "group": int(layout.split("/")[1]),
                  "variant": sorted(variants), "kernel_ms": kernel_ms,
                  "w_sequential_ms": w_sequential_ms, "plain_ms": plain_ms, "library_ms": library_ms,
                  **_member_bound(W, g, members)}
        log("kernel_timing", iters=TIMED_ITERS, bound_divisor=f"{HBM_BYTES_PER_S:.3g} B/s (H100 SXM HBM3 peak)",
            **timing)
        timings.append(timing)
        torch.cuda.empty_cache()
    return worst, timings


def _bare_member_launch(batched, W=None, lib=None):
    """One member-axis launch straight through the library (or a copy of
    it, `lib`) on the ScanBatch that the vmap rule builds for the shape's
    vmapped call: fused_scan.vmap_batch's arguments, captured from one run
    of `batched`, built again for the first W members (all by default).
    Returns (zero-argument launch, its int64 [W, E, G] tables, the layout);
    the capture run is a counted wrapper call, the launch moves no counter."""
    import ctypes

    from pinot_tpu_torch.ops import fused_scan

    build, calls = fused_scan.vmap_batch, []

    def spy(*a):
        calls.append(a)
        return build(*a)

    fused_scan.vmap_batch = spy
    try:
        batched()
    finally:
        fused_scan.vmap_batch = build
    if len(calls) != 1:
        raise AssertionError(f"the vmapped call built {len(calls)} member-axis launches, want 1")
    args = list(calls[0])  # (dense, entries, key, key_bits, mask_words, pred, ranges, w0, W, G, smem_optin)
    if W is not None:
        args[8] = W
    b, order, _variant, layout = build(*args)
    real = fused_scan._library()
    lib = lib or real
    out = torch.zeros((b.h.members, len(order), args[9]), dtype=torch.int64, device=args[2].device)

    def launch():
        err = lib.pinot_fused_scan_batch(ctypes.byref(b), out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"member-axis launch failed: {real.pinot_cuda_error_string(err).decode()}")
    launch.batch = b
    launch.operands = args  # the tensors the batch points into stay alive with the launch
    return launch, out, layout


def _member_scan_ms(shapes, dev, timings):
    """Phase 5's device time of each member-axis shape's kernel, on phase
    3's inputs (kept on the card: ~2.1 GB): scan_ms (torch.profiler, each
    launch's own event) and launch_ms (CUDA events around a bare launch of
    the vmap rule's ScanBatch, median of TIMED_ITERS, L2 flushed).  The
    flush's share of a launch comes from member_phases.py's clocked copy of
    the kernel, which this script does not build."""
    flush = _flushes(dev)["write"]
    for timing, (label, _W, _g, _members, batched, _layout) in zip(timings, shapes):
        launch, _out, layout = _bare_member_launch(batched)
        timing["launch_ms"] = _time_cuda(launch, flush)
        timing["scan_ms"] = _device_ms(batched, flush, "fused_scan_batch_kernel", timing["launch_ms"])
        timing["group"] = layout.group
        timing["flush_ms"] = "see member_phases.py"
        log("kernel_profile", shape=label, scan_ms=timing["scan_ms"], launch_ms=timing["launch_ms"],
            group=timing["group"], iters=PROFILED_ITERS)
    torch.cuda.empty_cache()


def _member_axis_check(member_timings, dist_timing) -> dict:
    """The code-range shape (8 members over 2^27 rows) against 8 unbatched
    launches of the distributed main path's shape in the same run: its
    device ms must be under half of 8 x theirs (each shared stream read
    once, not 8 times).  Profiler times where both were measured, else the
    bare launches' CUDA-event times."""
    code_range = next(t for t in member_timings if t["shape"].startswith("dist batch: "))
    basis = "scan_ms"
    if not (isinstance(code_range["scan_ms"], float) and isinstance(dist_timing["scan_ms"], float)):
        basis = "launch_ms"
    got, one = code_range[basis], dist_timing[basis]
    check = {"basis": basis, "member_axis_ms": got, "unbatched_ms": one, "limit_ms": 0.5 * BATCH_W * one,
             "ratio_to_8_unbatched": got / (BATCH_W * one)}
    log("member_axis_check", **check)
    if not got < 0.5 * BATCH_W * one:
        raise AssertionError(f"the code-range member-axis launch is not under half of {BATCH_W} unbatched: {check}")
    return check


def _member_variants(seed: int, dev):
    """The member-axis grid on the card: (label, layouts, f, args), f(fn,
    *member args) one member's call of fn (the wrapper or the plain
    version), args stacked on dim 0; layouts the launches' "W/Wg" the
    vmapped call must make.  Stacked and shared keys, masks, values, words
    and code ranges; the specialised and generic instantiations; ragged
    tails and rows with no common aligned head (scalar tiles); two entry
    chunks, two member chunks, two member groups and the global path."""
    from pinot_tpu_torch.ops import fused_scan

    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def words_of(n, W):
        return t(np.packbits(rng.random((W, n)) < 0.5, axis=1, bitorder="little").view(np.int32))

    out = []
    W, n, g = 5, 512 * 40 + 38, 2406
    pk = t(_pack(rng.integers(0, g + 40, n).astype(np.int32), 16).view(np.int32))
    vals = t(rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32))
    shared_mask = t(rng.random(n) < 0.7)
    thr = t(rng.integers(-(2**30), 2**30, W).astype(np.int32))

    def f1(fn, th):
        m = vals < th
        return fn([("count", None, m, None), ("int_sum", vals, m, (4, True)), ("count", None, shared_mask, None),
                   ("int_sum", vals, shared_mask, (4, True))], None, g, codes_packed=(pk, 16))
    out.append(("p16 key shared, stacked and shared masks, ragged tail, W=5 in groups of 4 and 1", {"5/4": 1},
                f1, (thr,)))

    n = 512 * 64
    key = t(rng.integers(-3, 553, n).astype(np.int32))
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    vals2 = t(rng.integers(100, 1_000_000, n).astype(np.int32))

    def f2(fn, w):
        return fn([("count", None, ones, None), ("int_sum", vals2, ones, (3, False))], key, 550, mask_words=w)
    out.append(("i32 key shared, stacked mask_words", {"5/5": 1}, f2, (words_of(n, W),)))

    pc = t(rng.integers(0, 11, n).astype(np.uint8))
    big = t(rng.integers(-(2**39), 2**39, n).astype(np.int64))
    los = t(rng.integers(0, 8, W).astype(np.int64))

    def f3(fn, lo, w):
        return fn([("count", None, ones, None), ("int64_sum", big, ones, 5)], key, 550, mask_words=w,
                  code_pred=(pc, lo, lo + 3))
    out.append(("per-member code ranges over shared uint8 codes, stacked words, int64 sums (generic)",
                {"5/1": 1}, f3, (los, words_of(n, W))))

    n = 512 * 30 + 11
    keys = t(rng.integers(0, 300, (W, n)).astype(np.int16))
    vs = t(rng.integers(0, 65536, (W, n)).astype(np.uint16))
    m4 = t(rng.random(n) < 0.6)

    def f4(fn, k, v):
        return fn([("count", None, m4, None), ("int_sum", v, m4, (2, False))], k, 300)
    out.append(("stacked int16 keys and uint16 values (generic, each member's key)", {"5/1": 1}, f4, (keys, vs)))
    keys32 = t(rng.integers(-2, 302, (W, n)).astype(np.int32))
    v4 = t(rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32))

    def f4b(fn, k):
        return fn([("count", None, m4, None), ("int_sum", v4, m4, (4, True))], k, 300)
    out.append(("stacked int32 keys, shared int32 values (i32/i32, each member's key)", {"5/1": 1}, f4b,
                (keys32,)))

    n = 8192 + 5
    key5 = t(rng.integers(0, 50, n).astype(np.int32))
    v5 = t(rng.integers(-1000, 1000, n).astype(np.int32))

    def f5(fn, th):
        return fn([("int_sum", v5 + i, v5 < th + i, None) for i in range(fused_scan.MAX_ENTRIES + 3)], key5, 50)
    out.append(("19 entries (two entry chunks), stacked masks", {"5/5": 2}, f5,
                (t(rng.integers(-500, 500, W).astype(np.int32)),)))

    n = 1 << 16
    pk6 = t(_pack(rng.integers(0, g, n).astype(np.int32), 16).view(np.int32))
    rev6 = t(rng.integers(100, 1_000_000, n).astype(np.int32))
    qty6 = t(rng.integers(1, 51, n).astype(np.int32))

    def f6(fn, k):
        m = qty6 < k
        return fn([("count", None, m, None), ("int_sum", rev6, m, (3, False)), ("int_sum", qty6, m, (1, False))],
                  None, g, codes_packed=(pk6, 16))
    out.append(("3 entries over G=2406, W=8 (two groups of 4)", {"8/4": 1}, f6,
                (torch.arange(18, 26, dtype=torch.int32, device=dev),)))

    n = 1 << 18
    key7 = t(rng.integers(0, 8192, n).astype(np.int32))
    v7 = t(rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32))

    def f7(fn, th):
        m = v7 < th
        return fn([("int_sum", v7, m, None), ("int_sum", v7 >> 3, m, None), ("int_sum", v7 >> 5, m, None),
                   ("int_sum", v7 >> 7, m, None)], key7, 8192)
    out.append(("G=8192, 4 sums (global path, one member a grid row)", {"3/1": 1}, f7,
                (t(rng.integers(-(2**30), 2**30, 3).astype(np.int32)),)))

    n = 1 << 16
    pk8 = t(_pack(rng.integers(0, 14, n).astype(np.int32), 4).view(np.int32))
    m8 = t(rng.integers(0, 8, n).astype(np.int32))
    v8 = t(rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32))

    def f8(fn, k):
        m = m8 < k
        return fn([("count", None, m, None), ("int_sum", v8, m, None)], None, 11, codes_packed=(pk8, 4))
    out.append(("p4 key shared (generic: one member a grid row), W=8", {"8/1": 1}, f8,
                (torch.arange(1, 9, dtype=torch.int32, device=dev),)))

    n = 1025
    key9 = t(rng.integers(0, 50, n).astype(np.int32))
    v9 = t(rng.integers(-100, 100, (3, n)).astype(np.int8))
    m9 = t(rng.random(n) < 0.5)

    def f9(fn, v):
        return fn([("count", None, m9, None), ("int_sum", v, m9, (1, True))], key9, 50)
    out.append(("stacked int8 values 1025 rows apart (no common aligned head; generic)", {"3/1": 1}, f9, (v9,)))

    n = 4096 + 16
    key10 = t(rng.integers(0, 37, n).astype(np.int32))
    v10 = t(rng.integers(-1000, 1000, n).astype(np.int32))

    def f10(fn, th):
        m = v10 < th
        return fn([("count", None, m, None), ("int_sum", v10, m, None)], key10, 37)
    out.append(("W=10 (two member chunks)", {"8/8": 1, "2/2": 1}, f10,
                (t(rng.integers(-1000, 1000, 10).astype(np.int32)),)))

    n = 512 * 24 + 7
    key11 = t(rng.integers(0, 100, n).astype(np.int32))
    ones11 = torch.ones(n, dtype=torch.bool, device=dev)
    v11 = t(rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32))

    def f11(fn, pc, lo):
        return fn([("count", None, ones11, None), ("int_sum", v11, ones11, None)], key11, 100,
                  code_pred=(pc, lo, lo + 6))
    out.append(("stacked int16 code ranges, i32 key shared (each member's codes in the group path)", {"5/5": 1}, f11,
                (t(rng.integers(-5, 20, (W, n)).astype(np.int16)), t(rng.integers(-5, 10, W).astype(np.int64)))))
    # int64 codes, half of them 2^32 past a code in range (a 32-bit compare
    # would count them), shared by the members of the group path
    pc12 = t(rng.integers(-5, 20, n).astype(np.int64) + (rng.random(n) < 0.5).astype(np.int64) * (1 << 32))

    def f12(fn, lo):
        return fn([("count", None, ones11, None), ("int_sum", v11, ones11, None)], key11, 100,
                  code_pred=(pc12, lo, lo + 6))
    out.append(("shared int64 code ranges, i32 key shared (the group path's 64-bit compare)", {"5/5": 1}, f12,
                (t(rng.integers(-5, 10, W).astype(np.int64)),)))
    pc13 = t(rng.integers(-300, 300, n).astype(np.int16))

    def f13(fn, lo):
        return fn([("count", None, ones11, None), ("int_sum", v11, ones11, None)], key11, 100,
                  code_pred=(pc13, lo, lo + 150))
    out.append(("shared int16 code ranges below and above 0, i32 key shared (read once, 32-bit compares)",
                {"5/5": 1}, f13, (t(rng.integers(-400, 200, W).astype(np.int64)),)))
    return out


def phase_member_grid(seed: int, dev) -> float:
    """Each _member_variants case: one vmapped wrapper call, its launches'
    layouts counted, held EXACTLY against the plain version member by
    member; the worst error."""
    import functools

    from pinot_tpu_torch.ops import fused_scan

    worst = 0.0
    for label, layouts, f, args in _member_variants(seed, dev):
        before = dict(fused_scan.BATCH_LAYOUTS)
        got = torch.func.vmap(functools.partial(f, fused_scan.fused_group_tables))(*args)
        torch.cuda.synchronize()
        made = {k: v - before.get(k, 0) for k, v in fused_scan.BATCH_LAYOUTS.items() if v != before.get(k, 0)}
        err = 0.0
        for w in range(args[0].shape[0]):
            ref = f(fused_scan.fused_group_tables_reference, *(a[w] for a in args))
            err = max(err, _max_abs_err([x[w] for x in got], ref))
        worst = max(worst, err)
        log("member_grid_check", case=label, max_abs_err=err, layouts=made)
        if err != 0.0:
            raise AssertionError(f"the member-axis scan differs from its plain version on {label}: {err}")
        if made != layouts:
            raise AssertionError(f"{label}: member-axis layouts {made}, want {layouts}")
    return worst


def _generic_scan(ents, key, g, kw):
    """The shape's scan through the generic shared instantiation (a bare
    launch with the key and value modes set to "any"); its f64 tables in
    entry order.  A comparison launch: no counter moves."""
    launch, out, order = _bare_launch(ents, key, g, kw, generic=True)
    launch()
    return [out[j].to(torch.float64) for j in sorted(range(len(order)), key=order.__getitem__)]


def phase_kernel_profile(seed: int, dev, timings):
    """Device times from torch.profiler, after the main path (a profiler
    session leaves tracing set up in the process, which would tax the main
    path's launches): for each timed shape, rebuilt from the same seed,
    scan_ms (the kernel's own device time); the specialised instantiation
    against the generic one at the two shapes the SQL path launches; and,
    at the main path's shape, what a write flush and a read flush each
    leave a streaming read of the inputs' bytes."""
    from pinot_tpu_torch.ops import fused_scan

    flushes = _flushes(dev)
    shapes = _shapes(seed, dev)
    for timing, (label, ents, key, g, kw) in zip(timings, shapes):
        timing["launch_ms"] = _time_cuda(_bare_launch(ents, key, g, kw)[0], flushes["write"])
        timing["scan_ms"] = _device_ms(lambda: fused_scan.fused_group_tables(ents, key, g, **kw),
                                       flushes["write"], "fused_scan_kernel", timing["launch_ms"])
        log("kernel_profile", shape=label, scan_ms=timing["scan_ms"], launch_ms=timing["launch_ms"],
            iters=PROFILED_ITERS)

    generic = {}
    for timing, (label, ents, key, g, kw) in zip(timings[1:3], shapes[1:3]):
        err = _max_abs_err(_generic_scan(ents, key, g, kw), fused_scan.fused_group_tables_reference(ents, key, g, **kw))
        if err != 0.0:
            raise AssertionError(f"the generic instantiation differs from the plain version at {label}: {err}")
        generic[label] = {"specialised": timing["variant"], "scan_ms": timing["scan_ms"], "generic_max_abs_err": err,
                          "generic_scan_ms": _device_ms(
                              lambda: _generic_scan(ents, key, g, kw), flushes["write"], "fused_scan_kernel",
                              _time_cuda(_bare_launch(ents, key, g, kw, generic=True)[0], flushes["write"]))}
    log("specialised_vs_generic", iters=PROFILED_ITERS, shapes=generic)

    # the main path's inputs, read in full (every revenue sector holds a
    # masked-in row), as one buffer of the same bytes: a float32 sum reads
    # it, a device copy reads and writes it
    label, ents, key, g, kw = shapes[1]
    key_in, _ = _key_input(ents, key, kw)
    nbytes = key_in.numel() * key_in.element_size() + sum(
        x.numel() * x.element_size() for x in [ents[0][2], *[v for _k, v, _m, _lp in ents if v is not None]])
    blob = torch.zeros(nbytes // 4, dtype=torch.float32, device=dev)
    dst = torch.empty_like(blob)
    check = {"shape": label, "input_bytes": nbytes}
    for name, flush in flushes.items():
        scan_ms = _device_ms(lambda: fused_scan.fused_group_tables(ents, key, g, **kw), flush, "fused_scan_kernel",
                             _time_cuda(_bare_launch(ents, key, g, kw)[0], flush))
        sum_ms = _time_cuda(blob.sum, flush)
        copy_ms = _time_cuda(lambda: dst.copy_(blob), flush)
        check[f"{name}_flush"] = {
            "scan_ms": scan_ms, "sum_ms": sum_ms, "copy_ms": copy_ms,
            "scan_TBps": nbytes / scan_ms / 1e9 if isinstance(scan_ms, float) else "not measured",
            "sum_TBps": nbytes / sum_ms / 1e9, "copy_TBps": 2 * nbytes / copy_ms / 1e9,
        }
    log("flush_check", **check)
    return generic, check


def _compile_report():
    """ptxas's registers, shared memory and spills of each instantiation, and
    the atomic instructions in the compiled kernels (cuobjdump -sass)."""
    import re
    from pathlib import Path

    from pinot_tpu_torch.ops import _build, fused_scan

    rows = []
    for r in _build.ptxas_report():
        m = re.search(r"ILi(\d+)ELi(\d+)ELb(\d)E", r["kernel"])
        name = (f"{fused_scan.KEY_MODES[int(m.group(1))]}/{fused_scan.VALUE_MODES[int(m.group(2))]}/"
                f"{'shared' if m.group(3) == '1' else 'global'}") if m else r["kernel"]
        rows.append({"variant": name, **{k: v for k, v in r.items() if k != "kernel"}})
    log("ptxas", kernels=rows)
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    objs = sorted(_build.BUILD_DIR.glob("*.o"))
    if not cuobjdump.exists() or not objs:
        log("sass_atomics", atomics="not measured (no cuobjdump or object file)")
        return
    counts = {}
    for o in objs:
        sass = subprocess.run([str(cuobjdump), "-sass", str(o)], capture_output=True, text=True, check=True).stdout
        for op in re.findall(r"\b((?:ATOMS|ATOMG|ATOM|REDG|RED)(?:\.[A-Z0-9_]+)*)", sass):
            counts[op] = counts.get(op, 0) + 1
    log("sass_atomics", atomics=counts)


def _shapes(seed: int, dev):
    """(label, entries, key, num_groups, kwargs) of the 9 timed shapes, on
    the card, made from the seed."""
    from pinot_tpu_torch.ops import segmented

    rng = np.random.default_rng(seed)
    # main-path shape: 2^23 rows, packed 16-bit key, 2406 groups, the shared
    # presence/COUNT(*) entry and SUM over int32 revenue (plan from stats)
    n, g = 1 << 23, 2406
    od = rng.integers(0, g, n).astype(np.int32)
    mask = torch.from_numpy(rng.random(n) < 0.48).to(dev)
    rev = torch.from_numpy(rng.integers(100, 1_000_000, n).astype(np.int32)).to(dev)
    words = torch.from_numpy(_pack(od, 16).view(np.int32)).to(dev)
    plan = segmented.sum_limb_plan(100, 999_999)
    main = [("count", None, mask, None), ("int_sum", rev, mask, plan)]
    # query (c)'s shape: the computed key discount * 50 + quantity - 1 as raw
    # int32 codes, 550 groups, no filter (one all-true mask)
    kc = torch.from_numpy((rng.integers(0, 11, n) * 50 + rng.integers(0, 50, n)).astype(np.int32)).to(dev)
    ones = torch.ones(n, dtype=torch.bool, device=dev)
    qc = [("count", None, ones, None), ("int_sum", rev, ones, plan)]
    k8 = torch.from_numpy(rng.integers(0, 8, n).astype(np.int32)).to(dev)
    k8192 = torch.from_numpy(rng.integers(0, 8192, n).astype(np.int32)).to(dev)

    def col(a):
        return torch.from_numpy(a).to(dev)

    e4 = [
        ("int_sum", col(rng.integers(-120, 120, n).astype(np.int8)), col(rng.random(n) < 0.8), (1, True)),
        ("int_sum", col(rng.integers(-(2**31), 2**31 - 1, n).astype(np.int32)), col(rng.random(n) < 0.8), (4, True)),
        ("int64_sum", col(rng.integers(-(2**39), 2**39, n).astype(np.int64)), col(rng.random(n) < 0.8), None),
        ("int_sum", col(rng.integers(100, 1_000_000, n).astype(np.int32)), col(rng.random(n) < 0.8), plan),
    ]
    # the distributed main path's launch: 2^27 rows, the packed 16-bit key,
    # the range-index words of lo_quantity < 25 (48% of rows) as mask_words,
    # the all-true entry mask (no padding, one batch) and int32 revenue
    n2 = 1 << 27
    words2 = torch.from_numpy(_pack(rng.integers(0, g, n2).astype(np.int32), 16).view(np.int32)).to(dev)
    qbits = np.packbits((rng.random(n2) < 0.48).reshape(-1, 32), axis=1, bitorder="little").view(np.int32)
    ones2 = torch.ones(n2, dtype=torch.bool, device=dev)
    rev2 = torch.from_numpy(rng.integers(100, 1_000_000, n2).astype(np.int32)).to(dev)
    dist = [("count", None, ones2, None), ("int_sum", rev2, ones2, plan)]
    # the distributed FILTER launch of query (e): the same key and words, a
    # second mask (lo_discount BETWEEN 1 AND 3) for the FILTERed SUM, and
    # SUM(lo_revenue * lo_discount) over int32 products with no range bound
    disc2 = rng.integers(0, 11, n2).astype(np.int32)
    fmask = torch.from_numpy((disc2 >= 1) & (disc2 <= 3)).to(dev)
    revdisc = rev2 * torch.from_numpy(disc2).to(dev)
    filt = [("count", None, ones2, None), ("int_sum", rev2, fmask, plan), ("int_sum", revdisc, ones2, (4, True))]
    # one MV segment's GROUP BY tags launch (phase 4f (t)): 2^22 rows x 8
    # element slots exploded to 2^25 rows, the computed int32 key of the
    # tag codes (300 groups), the row x length mask shared by the presence
    # and COUNT(*) entries, and SUM(v) over int32 v broadcast along the
    # element axis (planner.mv_explode)
    nm, width = MV_ROWS, 8
    mlen = rng.integers(0, width + 1, nm)
    mv_mask = torch.from_numpy((np.arange(width)[None, :] < mlen[:, None]).reshape(-1)).to(dev)
    mv_key = torch.from_numpy(rng.integers(0, MV_TAGS, nm * width).astype(np.int32)).to(dev)
    mv_v = torch.from_numpy(np.repeat(rng.integers(0, 100, nm).astype(np.int32), width)).to(dev)
    mv = [("count", None, mv_mask, None), ("int_sum", mv_v, mv_mask, segmented.sum_limb_plan(0, 99))]
    # the outer launch of phase 4g's IN (SELECT ...) query (y2), one
    # segment: GROUP BY lo_discount over its packed 4-bit key (11 groups,
    # the generic instantiation), the mask of lo_orderdate IN the top 100
    # of 2406 days (~4% of rows) shared by the presence/COUNT(*) entry and
    # SUM over int32 revenue
    disc = rng.integers(0, 11, n).astype(np.int32)
    in_mask = torch.from_numpy(np.isin(od, rng.choice(g, 100, replace=False))).to(dev)
    words4 = torch.from_numpy(_pack(disc, 4).view(np.int32)).to(dev)
    in_sub = [("count", None, in_mask, None), ("int_sum", rev, in_mask, plan)]
    # (z1)'s launch on phase 4h's join path: every fact row (2^27), the
    # computed int32 key of d_year gathered through the join (7 groups,
    # uniform here), the probe mask (lo_quantity < 25, every key matching:
    # 48% of rows) shared by the presence / COUNT(*) entry, and SUM over
    # int32 revenue
    kz = torch.from_numpy(rng.integers(0, 7, n2).astype(np.int32)).to(dev)
    zmask = torch.from_numpy(rng.random(n2) < 0.48).to(dev)
    join = [("count", None, zmask, None), ("int_sum", rev2, zmask, plan)]
    return [
        ("dist main path: n=2^27 packed16 G=2406 E=2, mask_words, all-true mask", dist, None, g,
         {"codes_packed": (words2, 16), "mask_words": torch.from_numpy(qbits.reshape(-1)).to(dev)}),
        ("main path: n=2^23 packed16 G=2406 E=2, shared mask", main, None, g, {"codes_packed": (words, 16)}),
        ("query (c): n=2^23 int32 key G=550 E=2, all-true mask", qc, kc, 550, {}),
        ("hot slots: n=2^23 int32 key G=8 E=2, shared mask", main, k8, 8, {}),
        ("global path: n=2^23 int32 key G=8192 E=4 sums", e4, k8192, 8192, {}),
        ("dist FILTER launch: n=2^27 packed16 G=2406 E=3, mask_words, 2 masks (all-true, discount)", filt, None, g,
         {"codes_packed": (words2, 16), "mask_words": torch.from_numpy(qbits.reshape(-1)).to(dev)}),
        ("MV explode: n=2^22 x 8 = 2^25 int32 key G=300 E=2, row x length mask, broadcast int32 v", mv, mv_key,
         MV_TAGS, {}),
        ("IN (SELECT) outer: n=2^23 packed4 G=11 E=2, shared IN mask (~4%)", in_sub, None, 11,
         {"codes_packed": (words4, 4)}),
        ("join (z1): n=2^27 int32 computed key G=7 E=2, shared probe mask (48%)", join, kz, 7, {}),
    ]


def phase_kernels(rng, dev):
    """The variant grid, each case held exactly against the plain version;
    the worst error."""
    from pinot_tpu_torch.ops import fused_scan

    worst = 0.0
    fused_scan.VARIANT_LAUNCHES.clear()
    for label, entries, codes, g, kwargs in _variants(rng):
        ents, c, kw = _to_cuda(entries, codes, kwargs, dev)
        key = None if "codes_packed" in kw else c
        before, seen = fused_scan.LAUNCHES, dict(fused_scan.VARIANT_LAUNCHES)
        got = fused_scan.fused_group_tables(ents, key, g, **kw)
        torch.cuda.synchronize()
        launches = fused_scan.LAUNCHES - before
        ref = fused_scan.fused_group_tables_reference(ents, key, g, **kw)
        err = _max_abs_err(got, ref)
        worst = max(worst, err)
        ran = sorted(k for k, v in fused_scan.VARIANT_LAUNCHES.items() if v != seen.get(k, 0))
        log("kernel_check", variant=label, max_abs_err=err, launches=launches, instantiations=ran)
        if err != 0.0:
            raise AssertionError(f"fused scan differs from its plain version on {label}: {err}")
        if launches != -(-len(ents) // fused_scan.MAX_ENTRIES):
            raise AssertionError(f"{label}: {launches} launches for {len(ents)} entries")
    missing = set(fused_scan.INSTANTIATIONS) - set(fused_scan.VARIANT_LAUNCHES)
    if missing:
        raise AssertionError(f"the variant grid reached no launch of {sorted(missing)}")
    return worst


# ---------------------------------------------------------------------------
# phase 4: the main path at a real size
# ---------------------------------------------------------------------------
def lineorder_segment(rng, n: int):
    return {
        "lo_orderdate": (19920101 + rng.integers(0, 2406, n)).astype(np.int32),
        "lo_quantity": rng.integers(1, 51, n).astype(np.int32),
        "lo_discount": rng.integers(0, 11, n).astype(np.int32),
        "lo_revenue": rng.integers(100, 1_000_000, n).astype(np.int64),
    }


def golden(datas):
    """Exact int64 numpy results of the three queries."""
    a_sum = np.zeros(2406, np.int64)
    a_cnt = np.zeros(2406, np.int64)
    b_sum = b_cnt = 0
    c_cnt = np.zeros(11 * 50, np.int64)
    c_sum = np.zeros(11 * 50, np.int64)
    c_min = np.full(11 * 50, np.iinfo(np.int64).max)
    c_max = np.full(11 * 50, np.iinfo(np.int64).min)
    for d in datas:
        od, q, disc, rev = d["lo_orderdate"] - 19920101, d["lo_quantity"], d["lo_discount"], d["lo_revenue"]
        m = q < 25
        np.add.at(a_sum, od[m], rev[m])
        a_cnt += np.bincount(od[m], minlength=2406)
        mb = m & (disc >= 1) & (disc <= 3)
        b_sum += int(rev[mb].sum())
        b_cnt += int(mb.sum())
        k = disc * 50 + (q - 1)
        c_cnt += np.bincount(k, minlength=550)
        np.add.at(c_sum, k, rev)
        np.minimum.at(c_min, k, rev)
        np.maximum.at(c_max, k, rev)
    rows_a = sorted((19920101 + i, float(a_sum[i]), int(a_cnt[i])) for i in np.nonzero(a_cnt)[0])
    rows_b = [(float(b_sum), b_cnt)]
    order = sorted(np.nonzero(c_cnt)[0], key=lambda i: -c_sum[i])[:10]
    rows_c = [(int(i // 50), int(i % 50 + 1), int(c_cnt[i]), float(c_sum[i]), float(c_min[i]), float(c_max[i]))
              for i in order]
    return rows_a, rows_b, rows_c


def phase_main_path(args, dev):
    from pinot_tpu_torch.ops import fused_scan
    from pinot_tpu_torch.query.engine import QueryEngine
    from pinot_tpu_torch.segment.builder import build_segment
    from pinot_tpu_torch.spi.config import IndexingConfig, TableConfig
    from pinot_tpu_torch.spi.schema import DataType, FieldRole, FieldSpec, Schema

    t0 = time.perf_counter()
    rng = np.random.default_rng(args.seed)
    schema = Schema(
        "lineorder",
        [
            FieldSpec("lo_orderdate", DataType.INT),
            FieldSpec("lo_quantity", DataType.INT),
            FieldSpec("lo_discount", DataType.INT),
            FieldSpec("lo_revenue", DataType.LONG, role=FieldRole.METRIC),
        ],
    )
    cfg = TableConfig("lineorder", indexing=IndexingConfig(range_index_columns=["lo_quantity"]))
    engine = QueryEngine()  # device None: CUDA, raising without it
    datas = []
    for i in range(args.segments):
        d = lineorder_segment(rng, args.rows_per_segment)
        datas.append(d)
        if i == 0:
            engine.register_table(schema, cfg)
        engine.add_segment("lineorder", build_segment(schema, dict(d), f"lineorder_{i}", table_config=cfg))
    total_rows = args.segments * args.rows_per_segment
    build_s = time.perf_counter() - t0
    want_a, want_b, want_c = golden(datas)
    log("main_path_setup", segments=args.segments, rows=total_rows, build_and_golden_s=time.perf_counter() - t0,
        segment_build_s=build_s)

    # the counted run: counts set to 0 just before, read just after
    fused_scan.LAUNCHES = 0
    fused_scan.VARIANT_LAUNCHES.clear()
    res_a = engine.query(CONFIG2)
    launches_a = fused_scan.LAUNCHES
    res_b = engine.query(QUERY_B)
    launches_b = fused_scan.LAUNCHES - launches_a
    res_c = engine.query(QUERY_C)
    launches_c = fused_scan.LAUNCHES - launches_a - launches_b
    torch.cuda.synchronize()
    main_launches = fused_scan.LAUNCHES
    main_variants = dict(fused_scan.VARIANT_LAUNCHES)

    if sorted(res_a.rows) != want_a:
        raise AssertionError("query (a) differs from the numpy golden")
    if res_a.stats.filter_index_uses != (("lo_quantity", "range"),):
        raise AssertionError(f"query (a) did not ride the range index: {res_a.stats.filter_index_uses}")
    if res_b.rows != want_b:
        raise AssertionError(f"query (b) differs from the numpy golden: {res_b.rows} vs {want_b}")
    if res_c.rows != want_c:
        raise AssertionError(f"query (c) differs from the numpy golden: {res_c.rows} vs {want_c}")
    if launches_a < args.segments or launches_c < args.segments:
        raise AssertionError(
            f"the fused scan did not run on every segment: (a) {launches_a}, (c) {launches_c} launches"
        )
    log("main_path_check", exact=True, launches_a=launches_a, launches_b=launches_b, launches_c=launches_c,
        groups_a=len(res_a.rows), instantiations=main_variants)

    torch.cuda.reset_peak_memory_stats()
    timings = {}
    for name, sql in (("a_config2", CONFIG2), ("b_filtered_agg", QUERY_B), ("c_two_dim_groupby", QUERY_C)):
        ms = []
        for _ in range(5):
            s = time.perf_counter()
            engine.query(sql)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - s) * 1e3)
        med = statistics.median(ms)
        timings[name] = {"median_ms": med, "rows_per_s": total_rows / (med / 1e3), "runs_ms": ms}
    log("main_path_timing", rows=total_rows, max_memory_allocated=torch.cuda.max_memory_allocated(), **timings)
    profiles = [("main_path_profile", {"query": name}, engine, sql) for name, sql in (
        ("a_config2", CONFIG2), ("b_filtered_agg", QUERY_B), ("c_two_dim_groupby", QUERY_C))]
    return {"launches": main_launches, "variants": main_variants, "engine": engine, "datas": datas,
            "golden": {"a_config2": want_a, "b_filtered_agg": want_b, "c_two_dim_groupby": want_c},
            "profiles": profiles}


def _profile_once(engine, sql: str) -> dict:
    """One profiler session: the query once to open the trace (the first
    device events of a session can go missing), then the measured run,
    whose device events are those that start inside its
    ``record_function`` range."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from pinot_tpu_torch.ops import funnel_scan, fused_scan

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        engine.query(sql)
        torch.cuda.synchronize()
        before, funnel_before = fused_scan.LAUNCHES, funnel_scan.LAUNCHES
        t0 = time.perf_counter()
        with record_function("measured_query"):
            engine.query(sql)
            torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        made, funnel_made = fused_scan.LAUNCHES - before, funnel_scan.LAUNCHES - funnel_before
    events = prof.events()
    start = min(e.time_range.start for e in events if e.name == "measured_query")
    by_name = {}
    for e in events:
        # the range itself shows on the device timeline too: not device work
        if e.device_type != DeviceType.CUDA or e.time_range.start < start or e.name == "measured_query":
            continue
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    rows = [(ms, n, name) for name, (ms, n) in by_name.items()]
    rows.sort(reverse=True)
    out = {
        "profiled_wall_ms": wall_ms,
        "device_busy_ms": sum(r[0] for r in rows) if rows else "not measured",
        "scan_launches": {"made": made, "captured": sum(n for _ms, n, k in rows
                                                        if "fused_scan_kernel" in k or "fused_scan_batch_kernel" in k)},
        "funnel_scan_launches": {"made": funnel_made,
                                 "captured": sum(n for _ms, n, k in rows if "funnel_scan_kernel" in k)},
        "top_device_ops": [{"ms": ms, "calls": n, "name": k[:90]} for ms, n, k in rows[:8]],
    }
    if rows:
        out["device_idle_share"] = 1.0 - out["device_busy_ms"] / wall_ms
    return out


def profile_query(engine, sql: str, sessions: int = 3) -> dict:
    """Warm runs under torch.profiler, one session each: device time by
    kernel and the device's busy share of the (profiled) wall time.  On the
    card a session can lose device events (pageable host-to-device copies
    most often; after the earlier phases kernels too), never invent them.
    A session whose captured fused-scan launches fall short of the launches
    the query made is incomplete; the complete session with the most device
    time is reported, beside every session's.  With none complete, busy
    and idle are "not measured" and the most device time seen is a lower
    bound.  A session whose profiled run passes a second of wall and is
    complete is the only one (the sparse (d) and (o) of phase 4b and 4e)."""
    runs = []
    for _ in range(sessions):
        runs.append(_profile_once(engine, sql))
        r = runs[-1]
        # a query past a second of wall: one complete session does
        if (r["profiled_wall_ms"] > 1000.0 and isinstance(r["device_busy_ms"], float)
                and r["scan_launches"]["captured"] >= r["scan_launches"]["made"]):
            break
    busy = [r["device_busy_ms"] for r in runs]
    measured = [r for r in runs if isinstance(r["device_busy_ms"], float)]
    complete = [r for r in measured if r["scan_launches"]["captured"] >= r["scan_launches"]["made"]]
    if complete:
        best = max(complete, key=lambda r: r["device_busy_ms"])
        return {**best, "device_busy_ms_of_sessions": busy, "sessions": len(runs)}
    best = max(measured, key=lambda r: r["device_busy_ms"]) if measured else runs[0]
    return {**best, "device_busy_ms": "not measured", "device_idle_share": "not measured",
            "device_busy_ms_lower_bound": best["device_busy_ms"], "device_busy_ms_of_sessions": busy,
            "sessions": len(runs)}


# ---------------------------------------------------------------------------
# phase 4b: the distributed engine's main path (bench.py main()) at full size
# ---------------------------------------------------------------------------
DIST_QUERIES = {
    "a_bench": (
        "SELECT lo_orderdate, SUM(lo_revenue) FROM lineorder "
        "WHERE lo_quantity < 25 GROUP BY lo_orderdate LIMIT 2500"
    ),
    "b_filtered_agg": QUERY_B,
    "c_min_max_groupby": (
        "SELECT lo_discount, lo_quantity, COUNT(*), SUM(lo_revenue), MIN(lo_revenue), MAX(lo_revenue) "
        "FROM lineorder WHERE lo_quantity < 25 GROUP BY lo_discount, lo_quantity "
        "ORDER BY SUM(lo_revenue) DESC LIMIT 10"
    ),
    "d_sparse_groupby": (
        "SET numGroupsLimit = 2000000; SELECT lo_orderdate, lo_quantity, lo_discount, SUM(lo_revenue), "
        "COUNT(*) FROM lineorder WHERE lo_quantity < 25 GROUP BY lo_orderdate, lo_quantity, lo_discount "
        "ORDER BY SUM(lo_revenue) DESC LIMIT 100"
    ),
}
# bench.py's table size (N_ROWS = 2^27, about SSB scale factor 22), and the
# launch budget that splits it into three launches (7.5 B a row packed)
DIST_ROWS = 1 << 27
DIST_THREE_BATCH_BYTES = 384 << 20


def dist_golden(d):
    """Exact numpy results of the four distributed queries.  Group sums use
    np.bincount's float64 weights: every partial sum is an integer below
    2^53 (at most ~2.8e10 a group here), so they are exact int64 values."""
    od, q, disc, rev = d["lo_orderdate"] - 19920101, d["lo_quantity"], d["lo_discount"], d["lo_revenue"]
    m = q < 25
    odm, qm, dm, rm = od[m], q[m], disc[m], rev[m]
    a_sum = np.bincount(odm, weights=rm, minlength=2406)
    a_cnt = np.bincount(odm, minlength=2406)
    rows_a = sorted((19920101 + int(i), float(a_sum[i])) for i in np.nonzero(a_cnt)[0])
    mb = m & (disc >= 1) & (disc <= 3)
    rows_b = [(float(rev[mb].sum()), int(mb.sum()))]
    k = dm * 50 + (qm - 1)
    order_k = np.argsort(k.astype(np.int16), kind="stable")  # radix sort: k < 550
    ks, rs = k[order_k], rm[order_k]
    starts = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
    groups = ks[starts]
    c_cnt = np.diff(np.r_[starts, len(ks)])
    c_sum = np.add.reduceat(rs, starts)
    c_min, c_max = np.minimum.reduceat(rs, starts), np.maximum.reduceat(rs, starts)
    top = sorted(range(len(groups)), key=lambda i: -c_sum[i])[:10]
    rows_c = [(int(groups[i] // 50), int(groups[i] % 50 + 1), int(c_cnt[i]), float(c_sum[i]), float(c_min[i]),
               float(c_max[i])) for i in top]
    key = odm.astype(np.int64) * 550 + (qm - 1) * 11 + dm
    d_sum = np.bincount(key, weights=rm, minlength=2406 * 550)
    d_cnt = np.bincount(key, minlength=2406 * 550)
    live = np.nonzero(d_cnt)[0]
    top_d = live[np.lexsort((live, -d_sum[live]))][:100]
    rows_d = [(19920101 + int(i // 550), int(i // 11 % 50 + 1), int(i % 11), float(d_sum[i]), int(d_cnt[i]))
              for i in top_d]
    return {"a_bench": rows_a, "b_filtered_agg": rows_b, "c_min_max_groupby": rows_c,
            "d_sparse_groupby": rows_d}, int(len(live))


def _dist_counted_run(engine, stacked, golden_rows):
    """The four queries once, with the counters set to 0 just before and
    read just after; checks of the rows and of the route each took."""
    from pinot_tpu_torch.ops import fused_scan, sparse_merge
    from pinot_tpu_torch.sql.parser import parse_query

    plans = {name: engine._plan(parse_query(sql), stacked) for name, sql in DIST_QUERIES.items()}
    fused_scan.LAUNCHES = fused_scan.MASK_WORDS_LAUNCHES = sparse_merge.MERGES = 0
    fused_scan.VARIANT_LAUNCHES.clear()
    per_query, rows = {}, {}
    for name, sql in DIST_QUERIES.items():
        before = (fused_scan.LAUNCHES, fused_scan.MASK_WORDS_LAUNCHES, sparse_merge.MERGES,
                  dict(fused_scan.VARIANT_LAUNCHES))
        res = engine.query(sql)
        rows[name] = res.rows
        per_query[name] = {
            "launches": fused_scan.LAUNCHES - before[0],
            "mask_words_launches": fused_scan.MASK_WORDS_LAUNCHES - before[1],
            "device_merges": sparse_merge.MERGES - before[2],
            "instantiations": {k: v - before[3].get(k, 0) for k, v in fused_scan.VARIANT_LAUNCHES.items()
                               if v != before[3].get(k, 0)},
            "batches": len(plans[name].batch_offsets),
            "kind": plans[name].kind,
            "index_uses": list(res.stats.filter_index_uses),
            "groups": res.stats.num_groups,
        }
    torch.cuda.synchronize()
    launches, variants = fused_scan.LAUNCHES, dict(fused_scan.VARIANT_LAUNCHES)

    for name, want in golden_rows.items():
        got = sorted(rows[name]) if name == "a_bench" else rows[name]
        if got != want:
            raise AssertionError(f"dist query {name} differs from the numpy golden: {got[:3]} vs {want[:3]}")
    nb = len(plans["a_bench"].batch_offsets)
    pa, pd = per_query["a_bench"], per_query["d_sparse_groupby"]
    if not (plans["a_bench"].row_sharded_params and plans["a_bench"].word_fused):
        raise AssertionError("query (a) did not take the word-fused route")
    if pa["launches"] != nb or pa["mask_words_launches"] != nb or pa["instantiations"] != {"p16/i32/shared": nb}:
        raise AssertionError(f"query (a) did not launch the fused scan once a batch with mask_words: {pa}")
    if plans["c_min_max_groupby"].word_fused or per_query["c_min_max_groupby"]["launches"] != nb:
        raise AssertionError(f"query (c) did not take the unpacked-words route: {per_query['c_min_max_groupby']}")
    if pd["kind"] != "groupby_sparse" or pd["device_merges"] != 1:
        raise AssertionError(f"query (d) did not run the device sparse merge: {pd}")
    return launches, variants, per_query, rows


def _dist_host_costs(engine, stacked, dev):
    """Host ms of the range-index words of query (a) (prefix[hi] &
    ~prefix[lo] over the flat doc space), of one plan (a plan-cache hit,
    words included), and of the words' per-batch slice and pageable copy
    to the card; medians of 5."""
    from pinot_tpu_torch.query import executor
    from pinot_tpu_torch.sql.parser import parse_query

    idx = stacked.indexes["range"]["lo_quantity"]
    hi = int(np.searchsorted(stacked.column("lo_quantity").dictionary.values, 25, side="left"))

    def med(fn):
        ts = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ts)

    ctx = parse_query(DIST_QUERIES["a_bench"])
    plan = engine._plan(ctx, stacked)
    (key,) = plan.row_sharded_params
    off, fresh = plan.batch_offsets[0]
    host = engine.batch_params(plan, off, fresh)[key]
    return {
        "words_host_ms": med(lambda: idx.range_bitmap(0, hi)),
        "plan_ms": med(lambda: engine._plan(ctx, stacked)),
        "slice_ms": med(lambda: engine.batch_params(plan, off, fresh)),
        "copy_ms": med(lambda: executor._param_tensor(host, dev)),
        "words_bytes_per_batch": int(host.nbytes),
    }


def phase_dist_main_path(args, dev):
    """StackedTable.build over 2^27 rows, DistributedEngine() at one launch
    and at three; exact against numpy; the literal sweep; wall times.  The
    profiles run later (run_profiles); the table, its host data and the
    engines stay for phase transform_path."""
    from pinot_tpu_torch.parallel.engine import DistributedEngine
    from pinot_tpu_torch.parallel.stacked import StackedTable
    from pinot_tpu_torch.spi.config import IndexingConfig, TableConfig
    from pinot_tpu_torch.spi.schema import DataType, FieldRole, FieldSpec, Schema

    t0 = time.perf_counter()
    rng = np.random.default_rng(args.seed)
    n = DIST_ROWS
    data = {
        "lo_orderdate": (19920101 + rng.integers(0, 2406, n)).astype(np.int32),
        "lo_quantity": rng.integers(1, 51, n).astype(np.int32),
        "lo_discount": rng.integers(0, 11, n).astype(np.int32),
        "lo_revenue": rng.integers(100, 1_000_000, n).astype(np.int64),
    }
    schema = Schema("lineorder", [
        FieldSpec("lo_orderdate", DataType.INT),
        FieldSpec("lo_quantity", DataType.INT),
        FieldSpec("lo_discount", DataType.INT),
        FieldSpec("lo_revenue", DataType.LONG, role=FieldRole.METRIC),
    ])
    cfg = TableConfig("lineorder", indexing=IndexingConfig(range_index_columns=["lo_quantity"]))
    t1 = time.perf_counter()
    stacked = StackedTable.build(schema, data, num_shards=1, table_config=cfg)
    build_s = time.perf_counter() - t1
    want, live_groups = dist_golden(data)
    engines = {"one_batch": DistributedEngine(),
               "three_batches": DistributedEngine(launch_bytes=DIST_THREE_BATCH_BYTES)}
    for e in engines.values():
        e.register_table("lineorder", stacked)
    log("dist_setup", rows=n, docs_per_shard=stacked.docs_per_shard, build_s=build_s,
        setup_s=time.perf_counter() - t0, sparse_live_groups=live_groups)

    launches, variants, checks, rows = 0, {}, {}, {}
    for label, e in engines.items():
        nl, nv, per_query, rows[label] = _dist_counted_run(e, stacked, want)
        launches += nl
        for k, v in nv.items():
            variants[k] = variants.get(k, 0) + v
        checks[label] = per_query
    if rows["one_batch"] != rows["three_batches"]:
        raise AssertionError("the three-launch rows differ from the one-launch rows")
    nb3 = checks["three_batches"]["a_bench"]["batches"]
    if checks["one_batch"]["a_bench"]["batches"] != 1 or nb3 != 3:
        raise AssertionError(f"batches: {checks['one_batch']['a_bench']['batches']} and {nb3}, want 1 and 3")
    log("dist_check", exact=True, launches=launches, instantiations=variants, per_query=checks)

    # the literal sweep of bench.py: one plan, 19 cache hits
    sweep = DistributedEngine()
    sweep.register_table("lineorder", stacked)
    for i in range(20):
        sweep.query("SELECT lo_orderdate, SUM(lo_revenue) FROM lineorder "
                    f"WHERE lo_quantity < {5 + (i % 40)} GROUP BY lo_orderdate LIMIT 2500")
    if (sweep.plan_misses, sweep.plan_hits) != (1, 19):
        raise AssertionError(f"literal sweep planned {sweep.plan_misses} times ({sweep.plan_hits} hits)")
    log("dist_sweep", queries=20, plan_misses=sweep.plan_misses, plan_hits=sweep.plan_hits)

    torch.cuda.reset_peak_memory_stats()
    timings = {}
    for label, e in engines.items():
        for name, sql in DIST_QUERIES.items():
            ms = []
            for _ in range(1 if name == "d_sparse_groupby" else 5):  # (d) takes ~6 s a run
                s = time.perf_counter()
                e.query(sql)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - s) * 1e3)
            med = statistics.median(ms)
            timings[f"{label}/{name}"] = {"median_ms": med, "rows_per_s": n / (med / 1e3), "runs_ms": ms}
    log("dist_timing", rows=n, max_memory_allocated=torch.cuda.max_memory_allocated(), **timings)
    log("dist_host_costs", **_dist_host_costs(engines["one_batch"], stacked, dev))
    # (d) is not profiled: a session runs it twice, ~16 s (cut for the
    # script's limit; PERF.md keeps an earlier run's device busy)
    profiles = [("dist_profile", {"engine": label, "query": name}, e, sql)
                for label, e in engines.items() for name, sql in DIST_QUERIES.items()
                if name != "d_sparse_groupby"]
    return {"launches": launches, "variants": variants, "engines": engines, "stacked": stacked, "data": data,
            "golden": want,
            "profiles": profiles}


# ---------------------------------------------------------------------------
# phase 4c: transforms, FILTER (WHERE ...), CASE, selections and windows on
# the tables phases 4 and 4b built
# ---------------------------------------------------------------------------
TRANSFORM_QUERIES = {
    "e_filter_groupby": (
        "SELECT lo_orderdate, COUNT(*), SUM(lo_revenue) FILTER (WHERE lo_discount BETWEEN 1 AND 3), "
        "SUM(lo_revenue * lo_discount) FROM lineorder WHERE lo_quantity < 25 GROUP BY lo_orderdate LIMIT 2500"
    ),
    # SSB Q1.1 on this flat table (it has no lo_extendedprice)
    "f_q1_1_analog": (
        "SELECT SUM(lo_revenue * lo_discount) FROM lineorder "
        "WHERE lo_discount BETWEEN 1 AND 3 AND lo_quantity < 25"
    ),
    "g_computed_key": (
        "SELECT MOD(lo_orderdate, 100), COUNT(*), SUM(CASE WHEN lo_discount > 5 THEN lo_revenue ELSE 0 END) "
        "FROM lineorder WHERE lo_quantity < 25 GROUP BY MOD(lo_orderdate, 100) "
        "ORDER BY MOD(lo_orderdate, 100) LIMIT 100"
    ),
    "h_selection_top": (
        "SELECT lo_orderdate, lo_quantity, lo_discount, lo_revenue FROM lineorder "
        "WHERE lo_quantity = 1 AND lo_discount = 0 ORDER BY lo_revenue DESC, lo_orderdate LIMIT 100"
    ),
    "i_selection_expr": (
        "SELECT lo_orderdate, lo_revenue * lo_discount FROM lineorder WHERE lo_quantity = 1 "
        "ORDER BY lo_orderdate, lo_revenue LIMIT 50 OFFSET 10"
    ),
    "j_windows": (
        "SELECT lo_orderdate, lo_revenue, RANK() OVER (PARTITION BY lo_orderdate ORDER BY lo_revenue DESC), "
        "SUM(lo_revenue) OVER (PARTITION BY lo_orderdate) FROM lineorder "
        "WHERE lo_quantity = 1 AND lo_discount = 0 AND lo_revenue > 990000 LIMIT 5000"
    ),
}
# the distributed engine refuses these, as the JAX package's does
TRANSFORM_SEGMENT_ONLY = ("i_selection_expr", "j_windows")
# (instantiation, distinct masks) of every scan launch a query must make
TRANSFORM_SCANS = {"e_filter_groupby": ("p16/i32/shared", 2), "g_computed_key": ("i32/i32/shared", 1)}


def _ordered_expect(keys: np.ndarray, rows: list, offset: int, limit: int):
    """The golden of an ORDER BY ... LIMIT/OFFSET selection whose order key
    may tie: (the window's keys, {key: Counter of every matched row with
    that key}).  keys: [n, k] sort keys of every matched row in the golden's
    stable order; rows the output rows in the same order."""
    from collections import Counter

    lo, hi = offset, min(offset + limit, len(rows))
    if hi <= lo:
        return [], {}
    first, last = lo, hi - 1
    while first > 0 and (keys[first - 1] == keys[lo]).all():
        first -= 1
    while last + 1 < len(rows) and (keys[last + 1] == keys[hi - 1]).all():
        last += 1
    cand = {}
    for j in range(first, last + 1):
        cand.setdefault(tuple(keys[j].tolist()), Counter())[rows[j]] += 1
    return [tuple(keys[j].tolist()) for j in range(lo, hi)], cand


def _ordered_exact(got: list, expect) -> bool:
    """Rows in ORDER BY order: each run of the golden's tied keys holds, in
    the port's rows at those positions, a sub-multiset of the matched rows
    with that key (the rows of the last tie group compare as a set)."""
    from collections import Counter

    window, cand = expect
    if len(got) != len(window):
        return False
    groups = {}
    for pos, key in enumerate(window):
        groups.setdefault(key, []).append(pos)
    for key, positions in groups.items():
        have = Counter(got[p] for p in positions)
        if any(n > cand[key][r] for r, n in have.items()):
            return False
    return True


def transform_golden(d, segment_only: bool):
    """Numpy goldens of TRANSFORM_QUERIES over the host columns `d` (rows in
    the engine's doc order).  Group sums use np.bincount's float64 weights:
    every partial sum is an integer below 2^53 (at most ~3e11 a group
    here), so they are exact; the scalar sum is int64."""
    od, q, disc, rev = (np.asarray(d[k]) for k in ("lo_orderdate", "lo_quantity", "lo_discount", "lo_revenue"))
    rev = rev.astype(np.int64)
    disc64 = disc.astype(np.int64)
    out = {}
    m = q < 25
    k = (od[m] - 19920101).astype(np.int64)
    rm, dm = rev[m], disc64[m]
    cnt = np.bincount(k, minlength=2406)
    fm = (dm >= 1) & (dm <= 3)
    fcnt = np.bincount(k[fm], minlength=2406)  # a SUM over no FILTER rows is NULL
    s1 = np.bincount(k, weights=np.where(fm, rm, 0), minlength=2406)
    s2 = np.bincount(k, weights=rm * dm, minlength=2406)
    out["e_filter_groupby"] = sorted(
        (19920101 + int(i), int(cnt[i]), float(s1[i]) if fcnt[i] else None, float(s2[i]))
        for i in np.nonzero(cnt)[0])
    mb = m & (disc64 >= 1) & (disc64 <= 3)
    out["f_q1_1_analog"] = [(float(int((rev[mb] * disc64[mb]).sum())),)]
    km = od[m].astype(np.int64) % 100
    gc = np.bincount(km, minlength=100)
    gs = np.bincount(km, weights=np.where(dm > 5, rm, 0), minlength=100)
    out["g_computed_key"] = [(int(i), int(gc[i]), float(gs[i])) for i in range(100) if gc[i]]
    ih = np.nonzero((q == 1) & (disc64 == 0))[0]
    oh = ih[np.lexsort((od[ih], -rev[ih]))][: 100 + 4096]  # every row a tie at the end can reach
    out["h_selection_top"] = _ordered_expect(
        np.stack([-rev[oh], od[oh].astype(np.int64)], 1),
        [(int(a), 1, 0, int(b)) for a, b in zip(od[oh], rev[oh])], 0, 100)
    if segment_only:
        ii = np.nonzero(q == 1)[0]
        oi = ii[np.lexsort((rev[ii], od[ii]))]
        head = oi[: 60 + 4096]  # every row a tie at the window's end can reach
        out["i_selection_expr"] = _ordered_expect(
            np.stack([od[head].astype(np.int64), rev[head]], 1),
            [(int(a), int(b) * int(c)) for a, b, c in zip(od[head], rev[head], disc64[head])], 10, 50)
        ij = np.nonzero((q == 1) & (disc64 == 0) & (rev > 990000))[0]
        by_date = {}
        for j in ij:
            by_date.setdefault(int(od[j]), []).append(int(rev[j]))
        out["j_windows"] = [
            (int(od[j]), int(rev[j]), 1 + sum(r > int(rev[j]) for r in by_date[int(od[j])]),
             float(sum(by_date[int(od[j])])))
            for j in ij
        ][:5000]
    return out


def _transform_exact(name: str, got_rows, want) -> bool:
    if name in ("h_selection_top", "i_selection_expr"):
        return _ordered_exact(list(got_rows), want)
    if name == "e_filter_groupby":
        return sorted(got_rows) == want
    return list(got_rows) == want


def _transform_counted_run(engine, names, golden, kind: str, plans=None):
    """Each query once, with the scan counters set to 0 just before and read
    just after the run (a spy on fused_scan.build_params, which only a
    launch calls on the SQL path, records each launch's distinct masks);
    the rows held against the golden and the route checked."""
    from pinot_tpu_torch.ops import fused_scan

    real = fused_scan.build_params
    seen = []

    def spy(*a, **k):
        p, order, variant = real(*a, **k)
        seen.append((variant, int(p.num_masks), bool(p.mask_words)))
        return p, order, variant

    fused_scan.build_params = spy
    try:
        fused_scan.LAUNCHES = fused_scan.MASK_WORDS_LAUNCHES = 0
        fused_scan.VARIANT_LAUNCHES.clear()
        out = {}
        for name in names:
            before = (fused_scan.LAUNCHES, fused_scan.MASK_WORDS_LAUNCHES, len(seen),
                      dict(fused_scan.VARIANT_LAUNCHES))
            res = engine.query(TRANSFORM_QUERIES[name])
            torch.cuda.synchronize()
            launched = seen[before[2]:]
            out[name] = {
                "launches": fused_scan.LAUNCHES - before[0],
                "mask_words_launches": fused_scan.MASK_WORDS_LAUNCHES - before[1],
                "instantiations": {k: v - before[3].get(k, 0) for k, v in fused_scan.VARIANT_LAUNCHES.items()
                                   if v != before[3].get(k, 0)},
                "masks_per_launch": [m for _v, m, _w in launched],
                "bytes_to_host": res.stats.bytes_to_host,
                "rows": len(res.rows),
                "exact": _transform_exact(name, res.rows, golden[name]),
            }
        launches, variants = fused_scan.LAUNCHES, dict(fused_scan.VARIANT_LAUNCHES)
    finally:
        fused_scan.build_params = real
    for name, r in out.items():
        if not r["exact"]:
            raise AssertionError(f"{kind} query {name} differs from the numpy golden")
        expected = TRANSFORM_SCANS.get(name)
        per_launch = len(plans[name].batch_offsets) if plans is not None else len(engine.tables["lineorder"].segments)
        want_launches = per_launch if expected else 0
        if r["launches"] != want_launches:
            raise AssertionError(f"{kind} query {name}: {r['launches']} scan launches, want {want_launches}: {r}")
        if expected and (r["instantiations"] != {expected[0]: want_launches}
                         or set(r["masks_per_launch"]) != {expected[1]}):
            raise AssertionError(f"{kind} query {name} did not launch {expected}: {r}")
        if expected and plans is not None and (not plans[name].word_fused or r["mask_words_launches"] != want_launches):
            raise AssertionError(f"{kind} query {name} did not read the filter words in every launch: {r}")
        if name.startswith(("h_", "i_")) and not r["bytes_to_host"]:
            raise AssertionError(f"{kind} selection {name} copied no doc ids home: {r}")
    return launches, variants, out


def _wall_ms(engine, sql: str, runs: int = 5) -> dict:
    ms = []
    for _ in range(runs):
        t0 = time.perf_counter()
        engine.query(sql)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return {"median_ms": statistics.median(ms), "runs_ms": ms}


def phase_transform_path(seg, dist):
    """(e)-(j) on the segment engine's 8 x 2^23 rows and (e)-(h) on the
    distributed engine's 2^27-row table at one launch and at three: each
    query once counted and held against its numpy golden, then warm wall
    times.  Returns the launches, the instantiations, each query's record
    and the profiles to run."""
    from pinot_tpu_torch.sql.parser import parse_query

    t0 = time.perf_counter()
    seg_cols = {k: np.concatenate([d[k] for d in seg["datas"]]) for k in seg["datas"][0]}
    seg_golden = transform_golden(seg_cols, segment_only=True)
    del seg_cols
    dist_golden_rows = transform_golden(dist["data"], segment_only=False)
    log("transform_setup", golden_s=time.perf_counter() - t0)

    records, launches, by_path, variants, profiles = {}, 0, {}, {}, []
    runs = [("segment_engine", seg["engine"], list(TRANSFORM_QUERIES), seg_golden, None)]
    for label, e in dist["engines"].items():
        names = [n for n in TRANSFORM_QUERIES if n not in TRANSFORM_SEGMENT_ONLY]
        plans = {n: e._plan(parse_query(TRANSFORM_QUERIES[n]), dist["stacked"]) for n in names}
        runs.append((f"dist_{label}", e, names, dist_golden_rows, plans))
        for n in TRANSFORM_SEGMENT_ONLY:
            try:
                e.query(TRANSFORM_QUERIES[n])
            except NotImplementedError as err:
                records[f"dist_{label}/{n}"] = {"refused": str(err)}
            else:
                raise AssertionError(f"the distributed engine answered {n}, which the JAX package refuses")
    for label, e, names, golden_rows, plans in runs:
        nl, nv, per_query = _transform_counted_run(e, names, golden_rows, label, plans)
        launches += nl
        by_path[label] = nl
        for k, v in nv.items():
            variants[k] = variants.get(k, 0) + v
        for name, r in per_query.items():
            if plans is not None:
                r["batches"] = len(plans[name].batch_offsets)
            records[f"{label}/{name}"] = r
    for label, e, names, _g, _p in runs:
        for name in names:
            records[f"{label}/{name}"].update(_wall_ms(e, TRANSFORM_QUERIES[name]))
            profiles.append(("transform_profile", {"engine": label, "query": name}, e, TRANSFORM_QUERIES[name]))
    log("transform_check", exact=True, launches=launches, launches_by_engine=by_path, instantiations=variants)
    return {"launches": launches, "variants": variants, "records": records, "profiles": profiles,
            "seg_golden": seg_golden}


# ---------------------------------------------------------------------------
# phase 4e: sketches and the extended aggregations on the tables phases 4
# and 4b built; the ordered funnel's CUDA row scan
# ---------------------------------------------------------------------------
SKETCH_QUERIES = {
    "k_config3": (
        "SELECT lo_discount, lo_quantity, DISTINCTCOUNTHLL(lo_orderdate), PERCENTILETDIGEST(lo_revenue, 95), "
        "COUNT(*), SUM(lo_revenue) FROM lineorder WHERE lo_quantity < 25 GROUP BY lo_discount, lo_quantity "
        "ORDER BY lo_discount, lo_quantity LIMIT 300"
    ),
    "l_distinct_agg": (
        "SELECT DISTINCTCOUNT(lo_orderdate), DISTINCTCOUNT(lo_revenue), DISTINCTCOUNTHLL(lo_revenue), "
        "PERCENTILEKLL(lo_revenue, 99), MODE(lo_discount) FROM lineorder WHERE lo_quantity < 25"
    ),
    "m_stats_groupby": (
        "SELECT lo_discount, DISTINCTCOUNTTHETA(lo_revenue), COVAR_POP(lo_quantity, lo_revenue), "
        "CORR(lo_quantity, lo_revenue), EXPR_MAX(lo_orderdate, lo_revenue), "
        "LASTWITHTIME(lo_revenue, lo_orderdate, 'LONG'), HISTOGRAM(lo_quantity, 0, 50, 10) FROM lineorder "
        "GROUP BY lo_discount ORDER BY lo_discount LIMIT 20"
    ),
    "n_ordered_funnel": (
        "SELECT FUNNELCOUNT(STEPS(lo_discount = 0, lo_quantity < 10, lo_discount >= 8), CORRELATEBY(lo_revenue), "
        "TIMESTAMPBY(lo_orderdate), 400) FROM lineorder"
    ),
    "o_sparse_hll": (
        "SET numGroupsLimit = 2000000; SELECT lo_orderdate, lo_quantity, lo_discount, SUM(lo_revenue), COUNT(*), "
        "DISTINCTCOUNTHLL(lo_revenue, 5) FROM lineorder WHERE lo_quantity < 25 "
        "GROUP BY lo_orderdate, lo_quantity, lo_discount ORDER BY SUM(lo_revenue) DESC LIMIT 100"
    ),
}
SKETCH_DIST_ONLY = ("o_sparse_hll",)
# the queries whose dense group-by launches the fused scan once a launch of
# the engine (the presence table, and (k)'s COUNT/SUM, beside the sketches)
SKETCH_SCANS = ("k_config3", "m_stats_groupby")
FUNNEL_WINDOW = 400.0
FUNNEL_CHECK_ROWS = 1 << 20
# one key's rows for the huge-key walk (checked against a scalar loop)
FUNNEL_HUGE_ROWS = 1 << 20
SKETCH_RTOL = 1e-9
# warm runs of the slow sketch queries ((o) ~9 s a run, (m) ~1 s), cut for
# the script's limit; the others take 5
SKETCH_WALL_RUNS = {"o_sparse_hll": 1, "m_stats_groupby": 3}


def _np_hash32(x):
    """murmur3 finalizer on uint32 numpy lanes (the golden's own hash)."""
    with np.errstate(over="ignore"):
        h = x.astype(np.uint32)
        h ^= h >> np.uint32(16)
        h *= np.uint32(0x85EBCA6B)
        h ^= h >> np.uint32(13)
        h *= np.uint32(0xC2B2AE35)
        h ^= h >> np.uint32(16)
    return h


def _np_hash_int(v, itemsize, seed=0):
    """The device hash of integers stored `itemsize` bytes wide: an 8-byte
    value hashes its two 32-bit words, a narrower one its int32 bits."""
    s = np.uint32(seed)
    v = np.asarray(v).astype(np.int64)
    if itemsize < 8:
        return _np_hash32(v.astype(np.int32).view(np.uint32) ^ s)
    w0 = (v & 0xFFFFFFFF).astype(np.uint32)
    w1 = ((v >> 32) & 0xFFFFFFFF).astype(np.uint32)
    return _np_hash32((w0 ^ s) ^ _np_hash32(w1 ^ s))


def _np_hash62(v, itemsize):
    h1, h2 = _np_hash_int(v, itemsize), _np_hash_int(v, itemsize, 0x9E3779B9)
    return ((h1 & np.uint32(0x7FFFFFFF)).astype(np.int64) << 31) | (h2 >> np.uint32(1)).astype(np.int64)


def _np_device_rho(w, nbits):
    """The JAX package's float32 floor(log2 w) as the port defines it:
    floor(f32(log(f32 w)) * f32(1/ln 2)); the log in float64 on the CPU."""
    wf = np.maximum(w, 1).astype(np.float32).astype(np.float64)
    lg32 = torch.log(torch.from_numpy(wf)).numpy().astype(np.float32) * np.float32(1.0 / np.log(2.0))
    lg = np.floor(lg32).astype(np.int32)
    return np.where(w > 0, nbits - lg, nbits + 1).astype(np.int32)


def _np_dict_hll_tables(values, log2m):
    """(bucket, rho) per dictionary value: splitmix64 over the value's bits."""
    u = values.astype(np.int64).view(np.uint64)
    with np.errstate(over="ignore"):
        z = u + np.uint64(0x9E3779B97F4A7C15)
        z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
        z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
        h = z ^ (z >> np.uint64(31))
    w = h >> np.uint64(log2m)
    lg = np.floor(np.log2(np.maximum(w, 1).astype(np.float64))).astype(np.int32)
    nbits = 64 - log2m
    return (h & np.uint64((1 << log2m) - 1)).astype(np.int64), np.where(w > 0, nbits - lg, nbits + 1).astype(np.int32)


def _np_hll_final(regs):
    regs = np.asarray(regs, dtype=np.float64)
    m = regs.shape[-1]
    alpha = 0.7213 / (1 + 1.079 / m)
    est = alpha * m * m / np.sum(np.exp2(-regs), axis=-1)
    zeros = np.sum(regs == 0, axis=-1)
    with np.errstate(divide="ignore"):
        lc = m * np.log(np.where(zeros > 0, m / np.maximum(zeros, 1), 1.0))
    return np.rint(np.where((est <= 2.5 * m) & (zeros > 0), lc, est)).astype(np.int64)


def _np_percentile(hist, lo, hi, rank):
    bins = hist.shape[-1]
    total = hist.sum()
    if total == 0:
        return None
    target = rank / 100.0 * total
    cum = np.cumsum(hist.astype(np.float64))
    idx = min(int(np.searchsorted(cum, target, side="left")), bins - 1)
    prev = cum[idx - 1] if idx > 0 else 0.0
    frac = (target - prev) / hist[idx] if hist[idx] > 0 else 0.0
    return lo + (hi - lo) / bins * (idx + frac)


def _np_funnel_reach(key, ts, flags, num_steps, cells, window):
    """Deepest ordered funnel step per key (int32 [cells]): rows in stable
    (key, ts) order (one sort of key | ts | row packed into int64), then the
    chain DP over every key's run at once, one position at a time; the runs
    sorted longest first, so the runs still going are a prefix."""
    n = len(key)
    rb = max(1, int(n - 1).bit_length())
    tsn = ts.astype(np.int64) - int(ts.min())
    tb = max(1, int(tsn.max()).bit_length())
    packed = (key.astype(np.int64) << (tb + rb)) | (tsn << rb) | np.arange(n, dtype=np.int64)
    order = np.sort(packed) & ((1 << rb) - 1)
    ks, tss, fs = key[order], ts[order].astype(np.float64), flags[order]
    starts = np.flatnonzero(np.r_[True, ks[1:] != ks[:-1]])
    counts = np.diff(np.r_[starts, n])
    longest = np.argsort(-counts, kind="stable")
    starts, counts = starts[longest], counts[longest]
    neg = -float(2 ** 62)
    carry = np.full((num_steps, len(starts)), neg)
    for j in range(int(counts[0])):
        na = int(np.searchsorted(-counts, -j, side="left"))  # runs longer than j
        idx = starts[:na] + j
        t, f = tss[idx], fs[idx].astype(np.int32)
        for s in range(num_steps - 1, 0, -1):  # step s reads carry[s - 1] before its update
            lower, cur = carry[s - 1, :na], carry[s, :na]
            ext = (((f >> s) & 1) == 1) & (lower > neg) & (t - lower <= window)
            carry[s, :na] = np.where(ext, np.maximum(cur, lower), cur)
        carry[0, :na] = np.where((f & 1) == 1, t, carry[0, :na])
    out = np.zeros(cells, np.int32)
    out[ks[starts]] = (carry > neg).sum(axis=0)  # the live carries only grow
    return out


def _funnel_inputs(d, base):
    """(key, ts, step flags) of query (n) over one table's columns."""
    disc, q = d["lo_discount"], d["lo_quantity"]
    flags = ((disc == 0).astype(np.uint8) | ((q < 10).astype(np.uint8) << 1) | ((disc >= 8).astype(np.uint8) << 2))
    return (d["lo_revenue"] - base).astype(np.int32), d["lo_orderdate"], flags


def sketch_golden(parts, funnel_parts, rev_lo, rev_hi, rev_bytes):
    """Numpy goldens of (k)-(n) over a table given as a list of column
    dicts (the segments, or the stacked table as one part).  funnel_parts:
    the row sets the funnel's reach is computed over before the max merge
    (one per segment, or one per launch).  rev_bytes: the width lo_revenue
    is stored in on the table (the builder narrows it to int32 when its
    range fits), which the device hash reads."""
    cols = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]} if len(parts) > 1 else parts[0]
    od, q, disc, rev = cols["lo_orderdate"], cols["lo_quantity"], cols["lo_discount"], cols["lo_revenue"]
    odc = od - 19920101
    m = q < 25
    out = {}
    # (k): groups disc * 50 + (q - 1) over the dictionaries' codes
    g = (disc[m] * 50 + (q[m] - 1)).astype(np.int64)
    if all((np.bincount(p["lo_orderdate"] - 19920101, minlength=2406) > 0).all() for p in parts):
        # one lo_orderdate dictionary everywhere: host hash tables over it
        buckets, rhos = _np_dict_hll_tables(19920101 + np.arange(2406), 12)
        b_k, r_k = buckets[odc[m]], rhos[odc[m]]
    else:  # dictionaries differ: the column binds as a value range, hashed on the device
        h = _np_hash_int(od[m], 4)
        b_k, r_k = (h & np.uint32(4095)).astype(np.int64), _np_device_rho((h >> np.uint32(12)).astype(np.int64), 20)
    regs = np.zeros(550 * 4096, np.int32)
    np.maximum.at(regs, g * 4096 + b_k, r_k)
    est = _np_hll_final(regs.reshape(550, 4096))
    lo, hi = float(rev_lo), float(rev_hi)
    b = np.floor((rev[m].astype(np.float32) - np.float32(lo)) * np.float32(2048 / (hi - lo))).astype(np.int64)
    hist = np.bincount(g * 2048 + np.clip(b, 0, 2047), minlength=550 * 2048).reshape(550, 2048)
    cnt = np.bincount(g, minlength=550)
    sm = np.bincount(g, weights=rev[m], minlength=550)
    out["k_config3"] = [(int(i // 50), int(i % 50 + 1), int(est[i]), float(_np_percentile(hist[i], lo, hi, 95.0)),
                         int(cnt[i]), float(sm[i])) for i in np.nonzero(cnt)[0]]
    # (l)
    revm = rev[m]
    hb = _np_hash_int(revm, rev_bytes)
    regs_l = np.zeros(4096, np.int32)
    np.maximum.at(regs_l, (hb & np.uint32(4095)).astype(np.int64), _np_device_rho((hb >> np.uint32(12)).astype(np.int64), 20))
    kll = _kll_golden(revm, 99.0)
    mode = int(np.argmax(np.bincount(disc[m], minlength=11)))
    out["l_distinct_agg"] = [(int((np.bincount(odc[m], minlength=2406) > 0).sum()),
                              int((np.bincount(revm - int(rev_lo), minlength=int(rev_hi - rev_lo) + 1) > 0).sum()),
                              int(_np_hll_final(regs_l)), float(kll), float(mode))]
    del revm, hb
    # (m): per lo_discount
    out["m_stats_groupby"] = _stats_golden(odc, q, disc, rev, rev_bytes)
    # (n): reach per part, max-merged
    reach = None
    for p in funnel_parts:
        key, ts, flags = _funnel_inputs(p, int(rev_lo))
        r = _np_funnel_reach(key, ts, flags, 3, int(rev_hi - rev_lo) + 1, FUNNEL_WINDOW)
        reach = r if reach is None else np.maximum(reach, r)
    out["n_ordered_funnel"] = [([int((reach > s).sum()) for s in range(3)],)]
    return out


def _kll_golden(v, rank):
    """PERCENTILEKLL's log-bucket sketch (alpha 0.01) of positive values."""
    import math

    alpha = 0.01
    gamma = (1.0 + alpha) / (1.0 - alpha)
    lg = math.log(gamma)
    bins = int(math.ceil(math.log(1e12 / 1e-9) / lg)) + 1
    min_idx = int(math.floor(math.log(1e-9) / lg))
    idx = np.clip((np.log(v.astype(np.float64)) / lg).astype(np.int32) - min_idx, 0, bins - 1)
    hist = np.bincount(bins + 1 + idx, minlength=2 * bins + 1).astype(np.float64)
    cum = np.cumsum(hist)
    gi = min(int(np.searchsorted(cum, rank / 100.0 * hist.sum(), side="left")), 2 * bins)
    i = gi - bins - 1
    return math.exp((i + min_idx) * lg) * (2.0 * gamma / (gamma + 1.0))


def _stats_golden(odc, q, disc, rev, rev_bytes):
    rows = []
    dd = disc.astype(np.int64)
    n = np.bincount(dd, minlength=11).astype(np.float64)
    qf, rf = q.astype(np.float64), rev.astype(np.float64)
    sx, sy = np.bincount(dd, qf, 11), np.bincount(dd, rf, 11)
    sxy, ssx, ssy = np.bincount(dd, qf * rf, 11), np.bincount(dd, qf * qf, 11), np.bincount(dd, rf * rf, 11)
    cov = sxy / n - (sx / n) * (sy / n)
    corr = (sxy - sx * sy / n) / np.sqrt((ssx - sx * sx / n) * (ssy - sy * sy / n))
    # EXPR_MAX(lo_orderdate, lo_revenue): ties on revenue take the latest date;
    # LASTWITHTIME(lo_revenue, lo_orderdate): ties on the date take the largest revenue
    best_m = np.zeros(11, np.int64)
    np.maximum.at(best_m, dd, (rev << 12) | odc)
    best_t = np.zeros(11, np.int64)
    np.maximum.at(best_t, dd, (odc.astype(np.int64) << 20) | rev)
    hist = np.bincount(dd * 10 + np.minimum(q // 5, 9), minlength=110).reshape(11, 10)
    # DISTINCTCOUNTTHETA: the 256 smallest distinct 62-bit hashes of a group
    pres = np.bincount(dd * 1_000_000 + rev, minlength=11_000_000).reshape(11, 1_000_000) > 0
    for g in range(11):
        h = np.sort(np.partition(_np_hash62(np.flatnonzero(pres[g]), rev_bytes), 255)[:256])
        theta = float(h[-1]) / float(1 << 62)
        rows.append((g, float(255 / theta), float(cov[g]), float(corr[g]), float(19920101 + (best_m[g] & 4095)),
                     float(best_t[g] & ((1 << 20) - 1)), [float(c) for c in hist[g]]))
    return rows


def sparse_hll_golden(d, top_rows, rev_bytes):
    """(o): the (d) golden's top 100 groups with DISTINCTCOUNTHLL(lo_revenue, 5)."""
    od, q, disc, rev = d["lo_orderdate"] - 19920101, d["lo_quantity"], d["lo_discount"], d["lo_revenue"]
    m = q < 25
    key = od[m].astype(np.int64) * 550 + (q[m] - 1) * 11 + disc[m]
    want_keys = np.asarray([(r[0] - 19920101) * 550 + (r[1] - 1) * 11 + r[2] for r in top_rows], np.int64)
    sel = np.isin(key, want_keys)
    rank = np.searchsorted(np.sort(want_keys), key[sel])
    h = _np_hash_int(rev[m][sel], rev_bytes)
    regs = np.zeros(len(want_keys) * 32, np.int32)
    np.maximum.at(regs, rank * 32 + (h & np.uint32(31)).astype(np.int64), _np_device_rho((h >> np.uint32(5)).astype(np.int64), 27))
    est = _np_hll_final(regs.reshape(len(want_keys), 32))
    by_key = dict(zip(np.sort(want_keys).tolist(), est.tolist()))
    return [tuple(r) + (int(by_key[int(k)]),) for r, k in zip(top_rows, want_keys)]


def _sketch_exact(got, want) -> bool:
    import math

    def same(a, b):
        if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
            return len(a) == len(b) and all(same(x, y) for x, y in zip(a, b))
        if isinstance(a, float) and isinstance(b, float):
            return math.isclose(a, b, rel_tol=SKETCH_RTOL, abs_tol=0.0)
        return a == b and type(a) is type(b)

    return same([tuple(r) for r in got], [tuple(r) for r in want])


def _funnel_exact(prep, num_steps, cells, shape):
    """max_abs_err of the kernel against its plain version on the same
    prepared rows; raises where they differ."""
    from pinot_tpu_torch.ops import funnel_scan

    got = funnel_scan.scan_runs(*prep, num_steps, cells, FUNNEL_WINDOW)
    torch.cuda.synchronize()
    ref = funnel_scan.scan_runs_reference(*prep, num_steps, cells, FUNNEL_WINDOW)
    err = int((got.to(torch.int64) - ref.to(torch.int64)).abs().max())
    counts = prep[4]
    log("funnel_kernel_check", shape=shape, rows=int(prep[1].shape[0]), steps=num_steps, keys=int(prep[0].shape[0]),
        max_run_rows=int(counts.max()), runs_above_cap=int((counts > prep[5]).sum()), max_abs_err=err,
        keys_reached=int((ref > 0).sum()))
    if err:
        raise AssertionError(f"funnel scan differs from its plain version at {shape}: {err}")
    return err


def _funnel_kernel_checks(dev, seed):
    """The funnel kernel against its plain version at 2^20 rows, S = 3 and
    4 (exact), on random keys, steps and times with ties (ts in [0, 2406):
    ~52 rows a key).  Returns the worst error and S = 3's inputs, timed by
    _funnel_timing after the wall timings."""
    from pinot_tpu_torch.ops import _build, funnel_scan

    lib = _build.load()
    if lib.pinot_funnel_run_cap() != funnel_scan.RUN_CAP:
        raise AssertionError(f"the kernel orders runs of {lib.pinot_funnel_run_cap()} rows, the wrapper says "
                             f"{funnel_scan.RUN_CAP}")
    rng = np.random.default_rng(seed)
    n, keys = FUNNEL_CHECK_ROWS, 20_000
    worst, small = 0, None
    for s in (3, 4):
        inputs = (torch.from_numpy(rng.integers(0, keys, n).astype(np.int32)).to(dev),
                  [torch.from_numpy(rng.random(n) < 0.3).to(dev) for _ in range(s)],
                  torch.from_numpy(rng.integers(0, 2406, n).astype(np.int64)).to(dev),
                  torch.from_numpy(rng.random(n) < 0.9).to(dev), keys)
        worst = max(worst, _funnel_exact(funnel_scan.prepare(*inputs), s, keys, f"{n} rows, S = {s}"))
        if s == 3:
            small = (f"{n} rows, {keys} keys, S = 3 (the exactness check's shape)", inputs)
    # float timestamps that order apart (NaN, -0.0 against 0.0) or make
    # carry[0] fall (at or below -(2^62)), in short runs and in runs above the cap
    m = 1 << 16
    ts = rng.integers(-50, 50, m).astype(np.float64)
    odd = rng.random(m)
    ts[odd < 0.02] = np.nan
    ts[(odd >= 0.02) & (odd < 0.04)] = -1e300
    ts[(odd >= 0.04) & (odd < 0.06)] = -0.0
    codes = np.where(rng.random(m) < 0.1, 7, rng.integers(0, 400, m)).astype(np.int32)  # key 7: ~6,700 rows
    inputs = (torch.from_numpy(codes).to(dev), [torch.from_numpy(rng.random(m) < 0.4).to(dev) for _ in range(4)],
              torch.from_numpy(ts).to(dev), torch.ones(m, dtype=torch.bool, device=dev), 400)
    worst = max(worst, _funnel_exact(funnel_scan.prepare(*inputs), 4, 400, f"{m} rows, NaN and extreme ts, S = 4"))
    return worst, small


def _funnel_query_inputs(d, dev):
    """funnel_reach's inputs for query (n) over one table's columns."""
    base = int(d["lo_revenue"].min())
    cells = int(d["lo_revenue"].max()) - base + 1
    key, ts, flags = _funnel_inputs(d, base)
    steps = [torch.from_numpy(((flags >> s) & 1).astype(bool)).to(dev) for s in range(3)]
    return (torch.from_numpy(key).to(dev), steps, torch.from_numpy(ts).to(dev),
            torch.ones(len(key), dtype=torch.bool, device=dev), cells)


def _funnel_skewed_inputs(dev, seed):
    """Rows whose key order is built to hit the kernel's tile edges: two runs
    of exactly the cap ending on a window's end, a run above the cap opening
    the next window, runs of the cap and of the cap + 1, a run of the cap
    starting on a window's last row (its span's far end), ~2^20 rows of
    short runs (1-64 rows) around one skewed key of 6,000 rows; every row
    live, shuffled, ts in [0, 500) (many ties)."""
    from pinot_tpu_torch.ops import _build, funnel_scan

    rng = np.random.default_rng(seed)
    win, cap = int(_build.load().pinot_funnel_window_rows()), funnel_scan.RUN_CAP
    lens = [cap, cap, 3 * cap + 7, cap, cap + 1]
    at = sum(lens)
    pad = (-(at + 1)) % win  # one-row runs up to a window's last row
    lens += [1] * pad + [cap]
    short = list(rng.integers(1, 65, 32_000))
    lens += short[:16_000] + [6000] + short[16_000:]
    lens = np.asarray(lens, np.int64)
    n = int(lens.sum())
    key = np.repeat(np.arange(len(lens), dtype=np.int32), lens)
    order = rng.permutation(n)
    flags = rng.integers(1, 8, n)  # some step on every row
    steps = [torch.from_numpy(((flags[order] >> s) & 1).astype(bool)).to(dev) for s in range(3)]
    return (torch.from_numpy(key[order]).to(dev), steps,
            torch.from_numpy(rng.integers(0, 500, n).astype(np.int64)).to(dev),
            torch.ones(n, dtype=torch.bool, device=dev), len(lens))


def _funnel_scan_ms(fn, flush):
    """Device ms of one call's funnel-scan kernels (the tile bounds and the
    scan): each kernel's mean per captured launch, summed, over
    PROFILED_ITERS calls under torch.profiler (flush() before each)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_ITERS):
            flush()
            fn()
        torch.cuda.synchronize()
    per = {}
    for e in prof.key_averages():
        if "funnel_scan" in e.key and getattr(e, "device_type", None) == DeviceType.CUDA:
            us = getattr(e, "self_device_time_total", None)
            per[e.key] = (us if us is not None else getattr(e, "self_cuda_time_total", 0.0)) / e.count / 1e3
    return {"scan_ms": sum(per.values()) if per else "not measured", "scan_kernels_ms": per}


def _busy_ms(fn, iters: int = 5, sessions: int = 3):
    """Device ms a call keeps the card busy (every kernel and copy), the
    mean over `iters` profiled calls, and the top device ops: the session
    with the most device time of `sessions` (a session can lose events,
    never add any: a lower bound)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    best = {"device_ms": "not measured", "top_device_ops": []}
    for _ in range(sessions):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        rows = []
        for e in prof.key_averages():
            if getattr(e, "device_type", None) == DeviceType.CUDA:
                us = getattr(e, "self_device_time_total", None)
                rows.append(((us if us is not None else getattr(e, "self_cuda_time_total", 0.0)) / 1e3 / iters,
                             e.count // iters, e.key))
        rows.sort(reverse=True)
        total = sum(r[0] for r in rows)
        if rows and (best["device_ms"] == "not measured" or total > best["device_ms"]):
            best = {"device_ms": total,
                    "top_device_ops": [{"ms": ms, "calls": c, "name": k[:80]} for ms, c, k in rows[:6]]}
    return best


def _funnel_shape(label, inputs, flush, plain_iters=TIMED_ITERS):
    """One shape: the kernel exact against its plain version, then the
    wrapper call (kernel_ms), the kernels' device time (scan_ms), the byte
    bound, the plain version, prepare alone and the whole function
    (prepare + scan, funnel_reach) on the card."""
    from pinot_tpu_torch.ops import funnel_scan

    codes, steps, ts, mask, cells = inputs
    s = len(steps)
    prep = funnel_scan.prepare(*inputs)
    err = _funnel_exact(prep, s, cells, label)
    rows, runs = int(prep[1].shape[0]), int(prep[0].shape[0])
    # bytes the scan must move: the key-ordered ts (8) and flags (1) of
    # every live row, each run's key, start and count (4 + 8 + 8) read
    # once, the table (4 a cell) written once
    bound = (rows * 9 + runs * 20 + cells * 4) / HBM_BYTES_PER_S * 1e3
    # the same over every row the function was given, as a scan that also
    # read the masked and flagless rows would move
    bound_all = (int(codes.shape[0]) * 9 + runs * 20 + cells * 4) / HBM_BYTES_PER_S * 1e3
    out = {
        "shape": f"{label}: {int(codes.shape[0])} rows, {rows} live in {runs} runs (at most {int(prep[4].max())} "
                 f"rows, {int((prep[4] > prep[5]).sum())} above the cap of {prep[5]}), {cells} cells, S = {s}",
        "rows": int(codes.shape[0]), "live_rows": rows, "runs": runs, "cells": cells,
        "max_run_rows": int(prep[4].max()), "max_abs_err": err,
        "kernel_ms": _time_cuda(lambda: funnel_scan.scan_runs(*prep, s, cells, FUNNEL_WINDOW), flush),
        "bound_ms": bound, "bound_by": "bytes", "bound_all_rows_ms": bound_all,
        "plain_ms": _time_cuda(lambda: funnel_scan.scan_runs_reference(*prep, s, cells, FUNNEL_WINDOW), flush,
                               iters=plain_iters),
        "library_ms": None,
        "library": "none: no torch call orders rows within runs and walks the chain DP",
        "prepare_ms": _time_cuda(lambda: funnel_scan.prepare(*inputs), flush),
        "whole_ms": _time_cuda(lambda: funnel_scan.funnel_reach(*inputs, FUNNEL_WINDOW), flush),
    }
    out.update(_funnel_scan_ms(lambda: funnel_scan.scan_runs(*prep, s, cells, FUNNEL_WINDOW), flush))
    whole = _busy_ms(lambda: funnel_scan.funnel_reach(*inputs, FUNNEL_WINDOW))
    out.update(whole_device_ms=whole["device_ms"], whole_top_device_ops=whole["top_device_ops"])
    if isinstance(out["scan_ms"], float):
        out["share_of_bound"] = bound / out["scan_ms"]
    del prep
    torch.cuda.empty_cache()
    log("funnel_shape", **out)
    return out


def _huge_key_walk(dev, seed, flush):
    """One key of FUNNEL_HUGE_ROWS rows (ordered by prepare, walked by one
    thread a tile at a time): the kernel's time, which is latency bound,
    against a scalar loop over the same ordered rows."""
    from pinot_tpu_torch.ops import funnel_scan

    rng = np.random.default_rng(seed)
    n = FUNNEL_HUGE_ROWS
    ts = rng.integers(0, 1 << 20, n).astype(np.int64)
    flags = rng.integers(1, 8, n)
    steps = [torch.from_numpy(((flags >> s) & 1).astype(bool)).to(dev) for s in range(3)]
    inputs = (torch.zeros(n, dtype=torch.int32, device=dev), steps, torch.from_numpy(ts).to(dev),
              torch.ones(n, dtype=torch.bool, device=dev), 1)
    prep = funnel_scan.prepare(*inputs)
    got = int(funnel_scan.scan_runs(*prep, 3, 1, FUNNEL_WINDOW)[0])
    neg = -float(2 ** 62)
    carry, best = [neg] * 3, 0
    for i in np.argsort(ts, kind="stable").tolist():
        t, f = float(ts[i]), int(flags[i])
        for s in (2, 1):
            if (f >> s) & 1 and carry[s - 1] > neg and t - carry[s - 1] <= FUNNEL_WINDOW:
                carry[s] = max(carry[s], carry[s - 1])
        if f & 1:
            carry[0] = t
        best = max(best, sum(c > neg for c in carry))
    if got != best:
        raise AssertionError(f"funnel scan walks one key of {n} rows to {got}, the scalar loop to {best}")
    out = {"shape": f"one key of {n} rows, ordered by prepare, S = 3", "reach": got, "exact": True,
           "kernel_ms": _time_cuda(lambda: funnel_scan.scan_runs(*prep, 3, 1, FUNNEL_WINDOW), flush, iters=5)}
    out["ns_per_row"] = out["kernel_ms"] * 1e6 / n
    out.update(_funnel_scan_ms(lambda: funnel_scan.scan_runs(*prep, 3, 1, FUNNEL_WINDOW), flush))
    # the plain version steps once a row of the longest run, each step a
    # dozen tensor ops over every run: 2^20 steps here
    out["plain_ms"] = "not run: scan_runs_reference takes one step of ~12 tensor ops a row of the longest run " \
                      f"({n} steps)"
    log("funnel_huge_key", **out)
    return out


def _funnel_timing(seg_d, d, dev, small, seed):
    """The four shapes, each exact against the plain version and timed: the
    2^20-row check's, one segment's rows (the segment engine's launch), query
    (n)'s on the stacked table, and the skewed one; then one huge key."""
    flush = _flushes(dev)["write"]
    shapes = {"check": _funnel_shape(small[0], small[1], flush),
              "segment": _funnel_shape("query (n) on one segment", _funnel_query_inputs(seg_d, dev), flush),
              "n_stacked": _funnel_shape("query (n) on the stacked table", _funnel_query_inputs(d, dev), flush),
              "skewed": _funnel_shape("skewed keys at the tile edges", _funnel_skewed_inputs(dev, seed), flush,
                                      plain_iters=3)}
    out = dict(shapes["n_stacked"])
    out["max_abs_err"] = max(v["max_abs_err"] for v in shapes.values())
    out["shapes"] = shapes
    out["huge_key"] = _huge_key_walk(dev, seed + 1, flush)
    return out


def _sketch_counted_run(engine, names, golden_rows, label, scans_per_query):
    """Each query once, the scan counters set to 0 just before and read
    just after; rows held against the goldens, the kernels' launches checked."""
    from pinot_tpu_torch.ops import funnel_scan, fused_scan

    fused_scan.LAUNCHES = funnel_scan.LAUNCHES = 0
    fused_scan.VARIANT_LAUNCHES.clear()
    out = {}
    for name in names:
        before = (fused_scan.LAUNCHES, funnel_scan.LAUNCHES)
        t0 = time.perf_counter()
        res = engine.query(SKETCH_QUERIES[name])
        torch.cuda.synchronize()
        out[name] = {"first_ms": (time.perf_counter() - t0) * 1e3,
                     "fused_scan_launches": fused_scan.LAUNCHES - before[0],
                     "funnel_scan_launches": funnel_scan.LAUNCHES - before[1],
                     "rows": len(res.rows), "exact": _sketch_exact(res.rows, golden_rows[name])}
        if not out[name]["exact"]:
            raise AssertionError(f"{label} sketch query {name} differs from the numpy golden: "
                                 f"{list(res.rows)[:2]} vs {golden_rows[name][:2]}")
    for name, r in out.items():
        want_scan = scans_per_query if name in SKETCH_SCANS else 0
        want_funnel = scans_per_query if name == "n_ordered_funnel" else 0
        if r["fused_scan_launches"] != want_scan or r["funnel_scan_launches"] != want_funnel:
            raise AssertionError(f"{label} {name}: launches {r}, want fused {want_scan}, funnel {want_funnel}")
    return fused_scan.LAUNCHES, funnel_scan.LAUNCHES, dict(fused_scan.VARIANT_LAUNCHES), out


def phase_sketch_path(seg, dist, dev, seed):
    """(k)-(n) on the segment engine's 8 x 2^23 rows and (k)-(o) on the
    distributed engine's 2^27-row table at one launch: each query once
    counted and held against its numpy golden, then warm wall times; the
    funnel kernel against its plain version at 2^20 rows and timed at query
    (n)'s shape.  Returns the launches and the profiles to run."""
    t0 = time.perf_counter()
    worst, small = _funnel_kernel_checks(dev, seed)
    datas, d = seg["datas"], dist["data"]
    seg_lo = min(int(p["lo_revenue"].min()) for p in datas)
    seg_hi = max(int(p["lo_revenue"].max()) for p in datas)
    seg_bytes = seg["engine"].tables["lineorder"].segments[0].column("lo_revenue").values.dtype.itemsize
    dist_bytes = dist["stacked"].column("lo_revenue").values.dtype.itemsize
    seg_golden = sketch_golden(datas, datas, seg_lo, seg_hi, seg_bytes)
    dist_golden_rows = sketch_golden([d], [d], int(d["lo_revenue"].min()), int(d["lo_revenue"].max()), dist_bytes)
    dist_golden_rows["o_sparse_hll"] = sparse_hll_golden(d, dist["golden"]["d_sparse_groupby"], dist_bytes)
    log("sketch_setup", golden_s=time.perf_counter() - t0, lo_revenue_bytes={"segment": seg_bytes, "stacked": dist_bytes})

    engine_d = dist["engines"]["one_batch"]
    runs = [("segment_engine", seg["engine"], [n for n in SKETCH_QUERIES if n not in SKETCH_DIST_ONLY],
             seg_golden, len(seg["datas"])),
            ("dist_one_batch", engine_d, list(SKETCH_QUERIES), dist_golden_rows, 1)]
    records, fused, funnel, variants, profiles = {}, 0, 0, {}, []
    for label, e, names, golden_rows, per_query in runs:
        nf, nu, nv, per = _sketch_counted_run(e, names, golden_rows, label, per_query)
        fused += nf
        funnel += nu
        for k, v in nv.items():
            variants[k] = variants.get(k, 0) + v
        for name, r in per.items():
            records[f"{label}/{name}"] = r
    for label, e, names, _g, _n in runs:
        for name in names:
            records[f"{label}/{name}"].update(_wall_ms(e, SKETCH_QUERIES[name], runs=SKETCH_WALL_RUNS.get(name, 5)))
            if name != "o_sparse_hll":  # ~18 s a session: cut for the script's limit
                profiles.append(("sketch_profile", {"engine": label, "query": name}, e, SKETCH_QUERIES[name]))
    timing = _funnel_timing(datas[0], d, dev, small, seed + 1)
    timing["max_abs_err"] = max(worst, timing["max_abs_err"])
    log("sketch_check", exact=True, fused_scan_launches=fused, funnel_scan_launches=funnel, instantiations=variants,
        sketch_s=time.perf_counter() - t0)
    log("funnel_timing", **timing)
    return {"launches": fused, "funnel_launches": funnel, "variants": variants, "records": records,
            "profiles": profiles, "funnel": timing}


# ---------------------------------------------------------------------------
# phase 4f: index_path — multi-value columns (the MV explode through the
# fused scan), the star-tree on phase 4's lineorder rows (BASELINE config
# 4), and the JSON, text and vector indexes
# ---------------------------------------------------------------------------
# the MV table, shaped after Apache Pinot's airlineStats quickstart (its
# DivAirports / DivAirportIDs are STRING / INT multi-value columns)
MV_SEGMENTS = 4
MV_ROWS = 1 << 22
MV_TAGS = 300
MV_CITIES = 50
MV_QUERIES = {
    "p_any_filters": "SELECT COUNT(*) FILTER (WHERE tags = '{a}'), COUNT(*) FILTER (WHERE tags IN ('{b}', '{c}')), "
                     "COUNT(*) FILTER (WHERE tags NOT IN ('{a}', '{b}')) FROM mv",
    "q_scores_range": "SELECT COUNT(*), SUM(v) FROM mv WHERE scores BETWEEN 990 AND 1000",
    "r_mv_aggs": "SELECT COUNTMV(scores), SUMMV(scores), MINMV(scores), MAXMV(scores), DISTINCTCOUNTMV(tags) FROM mv",
    "s_city_summv": "SELECT city, SUMMV(scores), COUNTMV(scores) FROM mv GROUP BY city ORDER BY city LIMIT 100",
    "t_explode": "SELECT tags, COUNT(*), SUM(v) FROM mv GROUP BY tags ORDER BY tags LIMIT 1000",
    "u_city_tags": "SELECT city, tags, COUNT(*) FROM mv WHERE v < 50 GROUP BY city, tags ORDER BY city, tags "
                   "LIMIT 20000",
    "v_arraylength": "SELECT ARRAYLENGTH(tags), COUNT(*) FROM mv GROUP BY ARRAYLENGTH(tags) "
                     "ORDER BY ARRAYLENGTH(tags) LIMIT 100",
    "w_unnest": "SELECT city, UNNEST(tags) FROM mv WHERE v = 7 AND scores > 995 LIMIT 100000",
}
# the explode queries the distributed engine refuses (as the JAX package's
# does), and UNNEST, a selection expression it refuses likewise
MV_SEGMENT_ONLY = ("t_explode", "u_city_tags", "w_unnest")
# BASELINE config 4: the star-tree over phase 4's lineorder segments
STAR_CFG = {
    "dimensionsSplitOrder": ["lo_discount", "lo_quantity", "lo_orderdate"],
    "functionColumnPairs": ["COUNT__*", "SUM__lo_revenue", "MIN__lo_revenue", "MAX__lo_revenue"],
}
STAR_QUERIES = {  # (sql, the level it must come from)
    "t1_config2": (CONFIG2, 3),
    "t2_discount_sum": ("SELECT lo_discount, SUM(lo_revenue), COUNT(*) FROM lineorder WHERE lo_quantity < 25 "
                        "GROUP BY lo_discount LIMIT 100", 2),
    "t3_discount_extremes": ("SELECT lo_discount, MIN(lo_revenue), MAX(lo_revenue), AVG(lo_revenue) FROM lineorder "
                             "GROUP BY lo_discount LIMIT 100", 1),
    "t4_totals": ("SELECT SUM(lo_revenue), COUNT(*), MIN(lo_revenue), MAX(lo_revenue) FROM lineorder", 0),
}
STAR_RTOL = 1e-9
TEXT_SEGMENTS = 4
TEXT_ROWS = 1 << 20
TEXT_VALUES = 1 << 16
TEXT_WORDS = ["quick", "brown", "fox", "lazy", "dog", "jumps", "search", "engine", "analytics"]
TEXT_QUERIES = {  # predicate, golden over (json doc, body)
    "j1_tier": ("JSON_MATCH(meta, '\"$.user.tier\" = ''pro''')", lambda m, b: m["user"]["tier"] == "pro"),
    "j2_score_tier": ("JSON_MATCH(meta, '\"$.score\" > 5 AND \"$.user.tier\" != ''free''')",
                      lambda m, b: m["score"] > 5 and m["user"]["tier"] != "free"),
    "j3_events": ("JSON_MATCH(meta, '\"$.events[*].kind\" IS NOT NULL')", lambda m, b: bool(m["events"])),
    "x1_terms": ("TEXT_MATCH(body, 'quick fox')", lambda m, b: {"quick", "fox"} <= set(b.split())),
    "x2_or_not": ("TEXT_MATCH(body, 'search engine OR analytics NOT lazy')",
                  lambda m, b: {"search", "engine"} <= set(b.split())
                  or ("analytics" in b.split() and "lazy" not in b.split())),
    "x3_phrase": ("TEXT_MATCH(body, '\"quick brown\"')", lambda m, b: "quick brown" in b),
    "x4_prefix": ("TEXT_MATCH(body, 'jump*')", lambda m, b: any(t.startswith("jump") for t in b.split())),
    "x5_regex": ("TEXT_MATCH(body, '/qu.ck/')", lambda m, b: "quick" in b.split()),
    "x6_wildcard": ("TEXT_MATCH(body, 'an*tics')", lambda m, b: "analytics" in b.split()),
    "x7_fuzzy": ("TEXT_MATCH(body, 'quickk~1')", lambda m, b: "quick" in b.split()),
}
# one segment of 2^20 embeddings of 384 float32 (MiniLM sentence-embedding
# width): 1.5 GiB resident
VEC_ROWS = 1 << 20
VEC_DIM = 384
VEC_ATOL = 1e-5
VEC_CASES = (("k10", 10, False), ("k1000", 1000, False), ("k10_v50", 10, True), ("k1000_v50", 1000, True))


def mv_data(seed: int):
    """MV_SEGMENTS segments' parts from the seed: tags (0-8 elements a row
    over MV_TAGS three-letter codes, Zipf-skewed), scores (0-6 elements,
    0-1000), city (MV_CITIES values), v (0-99); codes into the sorted
    vocabularies, so a code's order is its value's."""
    rng = np.random.default_rng(seed)
    letters = np.array(list("ABCDEFGHIJKLMNOPQRSTUVWXYZ"))
    names = set()
    while len(names) < MV_TAGS:
        names.add("".join(rng.choice(letters, 3)))
    vocab = np.array(sorted(names), dtype=object)
    cities = np.array(sorted(f"city{i:02d}" for i in range(MV_CITIES)), dtype=object)
    weights = 1.0 / (1.0 + rng.permutation(MV_TAGS)) ** 1.1
    p = weights / weights.sum()
    parts = []
    for _ in range(MV_SEGMENTS):
        tl = rng.integers(0, 9, MV_ROWS).astype(np.int32)
        sl = rng.integers(0, 7, MV_ROWS).astype(np.int32)
        parts.append({
            "tags_len": tl, "tags": rng.choice(MV_TAGS, size=int(tl.sum()), p=p).astype(np.int32),
            "scores_len": sl, "scores": rng.integers(0, 1001, int(sl.sum())).astype(np.int32),
            "city": rng.integers(0, MV_CITIES, MV_ROWS).astype(np.int32),
            "v": rng.integers(0, 100, MV_ROWS).astype(np.int32),
        })
    return vocab, cities, parts


def _mv_inputs(part, vocab, cities):
    from pinot_tpu_torch.segment.builder import RaggedColumn

    return {"city": cities[part["city"]], "tags": RaggedColumn(vocab[part["tags"]], part["tags_len"]),
            "scores": RaggedColumn(part["scores"], part["scores_len"]), "v": part["v"]}


def _mv_schema():
    from pinot_tpu_torch.spi.schema import DataType, FieldRole, FieldSpec, Schema

    return Schema("mv", [
        FieldSpec("city", DataType.STRING),
        FieldSpec("tags", DataType.STRING, single_value=False),
        FieldSpec("scores", DataType.INT, single_value=False),
        FieldSpec("v", DataType.INT, role=FieldRole.METRIC),
    ])


def mv_golden(parts, vocab, cities, picks):
    """Exact numpy answers of MV_QUERIES over the concatenated parts."""
    cat = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    n = len(cat["v"])
    trow = np.repeat(np.arange(n), cat["tags_len"])
    srow = np.repeat(np.arange(n), cat["scores_len"])
    tags, scores, city, v = cat["tags"], cat["scores"], cat["city"], cat["v"]

    def any_rows(elem_mask, rows):
        m = np.zeros(n, dtype=bool)
        m[rows[elem_mask]] = True
        return m

    a, b, c = picks
    out = {"p_any_filters": [(int(any_rows(tags == a, trow).sum()), int(any_rows(np.isin(tags, [b, c]), trow).sum()),
                              int(any_rows(~np.isin(tags, [a, b]), trow).sum()))]}
    m = any_rows((scores >= 990) & (scores <= 1000), srow)
    out["q_scores_range"] = [(int(m.sum()), float(v[m].sum()))]
    out["r_mv_aggs"] = [(len(scores), float(scores.sum()), float(scores.min()), float(scores.max()),
                         len(np.unique(tags)))]
    ssum = np.bincount(city[srow], weights=scores, minlength=MV_CITIES)
    scnt = np.bincount(city[srow], minlength=MV_CITIES)
    present = np.bincount(city, minlength=MV_CITIES) > 0
    out["s_city_summv"] = [(cities[i], float(ssum[i]), int(scnt[i])) for i in np.nonzero(present)[0]]
    tcnt = np.bincount(tags, minlength=MV_TAGS)
    tsum = np.bincount(tags, weights=v[trow], minlength=MV_TAGS)
    out["t_explode"] = [(vocab[i], int(tcnt[i]), float(tsum[i])) for i in np.nonzero(tcnt)[0]]
    keep = v[trow] < 50
    ck = np.bincount(city[trow][keep] * MV_TAGS + tags[keep], minlength=MV_CITIES * MV_TAGS)
    out["u_city_tags"] = [(cities[i // MV_TAGS], vocab[i % MV_TAGS], int(ck[i])) for i in np.nonzero(ck)[0]]
    lc = np.bincount(cat["tags_len"], minlength=9)
    out["v_arraylength"] = [(i, int(lc[i])) for i in np.nonzero(lc)[0]]
    rows = (v == 7) & any_rows(scores > 995, srow)
    sel = rows[trow]
    out["w_unnest"] = sorted(zip(cities[city[trow][sel]].tolist(), vocab[tags[sel]].tolist()))
    return out


def _mv_exact(name, got, want) -> bool:
    if name == "w_unnest":
        return sorted(map(tuple, got)) == want
    return [tuple(r) for r in got] == want


def _index_counted_run(engine, queries, golden, label, exact):
    """Each query once, the fused scan's counters set to 0 just before and
    read just after; rows held against the goldens."""
    from pinot_tpu_torch.ops import fused_scan

    fused_scan.LAUNCHES = 0
    fused_scan.VARIANT_LAUNCHES.clear()
    out = {}
    for name, sql in queries.items():
        before = fused_scan.LAUNCHES
        t0 = time.perf_counter()
        res = engine.query(sql)
        torch.cuda.synchronize()
        out[name] = {"first_ms": (time.perf_counter() - t0) * 1e3, "fused_scan_launches": fused_scan.LAUNCHES - before,
                     "rows": len(res.rows), "num_docs_scanned": res.stats.num_docs_scanned,
                     "filter_index_uses": [list(u) for u in res.stats.filter_index_uses],
                     "exact": exact(name, res.rows, golden[name])}
        if not out[name]["exact"]:
            raise AssertionError(f"{label} {name} differs from the numpy golden: {list(res.rows)[:3]} vs "
                                 f"{golden[name][:3]}")
    return fused_scan.LAUNCHES, dict(fused_scan.VARIANT_LAUNCHES), out


def _index_mv(dev, seed):
    """The MV table on both engines: build, counted runs against the numpy
    goldens, the refusals of the distributed engine, warm medians."""
    from pinot_tpu_torch.parallel.engine import DistributedEngine
    from pinot_tpu_torch.parallel.stacked import StackedTable
    from pinot_tpu_torch.query.engine import QueryEngine
    from pinot_tpu_torch.segment.builder import RaggedColumn, build_segment

    t0 = time.perf_counter()
    vocab, cities, parts = mv_data(seed)
    tcnt = np.bincount(np.concatenate([p["tags"] for p in parts]), minlength=MV_TAGS)
    order = np.argsort(-tcnt, kind="stable")
    picks = (int(order[5]), int(order[20]), int(order[60]))  # tags of high, middle and low frequency
    queries = {k: q.format(a=vocab[picks[0]], b=vocab[picks[1]], c=vocab[picks[2]]) for k, q in MV_QUERIES.items()}
    gen_s = time.perf_counter() - t0
    schema = _mv_schema()
    engine = QueryEngine()
    engine.register_table(schema)
    t1 = time.perf_counter()
    for i, part in enumerate(parts):
        engine.add_segment("mv", build_segment(schema, _mv_inputs(part, vocab, cities), f"mv_{i}"))
    seg_build_s = time.perf_counter() - t1
    t1 = time.perf_counter()
    cat = {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
    stacked = StackedTable.build(schema, {
        "city": cities[cat["city"]], "tags": RaggedColumn(vocab[cat["tags"]], cat["tags_len"]),
        "scores": RaggedColumn(cat["scores"], cat["scores_len"]), "v": cat["v"]}, num_shards=1)
    stack_s = time.perf_counter() - t1
    del cat
    dist = DistributedEngine()
    dist.register_table("mv", stacked)
    golden = mv_golden(parts, vocab, cities, picks)
    width = engine.table("mv").segments[0].column("tags").codes.shape[1]
    log("index_mv_setup", segments=MV_SEGMENTS, rows=MV_SEGMENTS * MV_ROWS,
        tag_elements=int(sum(len(p["tags"]) for p in parts)), score_elements=int(sum(len(p["scores"]) for p in parts)),
        tags_width=width, generate_s=gen_s, segment_build_s=seg_build_s, stacked_build_s=stack_s,
        setup_s=time.perf_counter() - t0)
    del parts

    n_seg, v_seg, rec_seg = _index_counted_run(engine, queries, golden, "mv segment engine", _mv_exact)
    dist_q = {k: q for k, q in queries.items() if k not in MV_SEGMENT_ONLY}
    n_dist, v_dist, rec_dist = _index_counted_run(dist, dist_q, golden, "mv distributed engine", _mv_exact)
    if rec_seg["t_explode"]["fused_scan_launches"] != MV_SEGMENTS:
        raise AssertionError(f"the MV explode launched the fused scan {rec_seg['t_explode']['fused_scan_launches']} "
                             f"times on {MV_SEGMENTS} segments")
    if v_seg.get("i32/i32/shared", 0) < MV_SEGMENTS:
        raise AssertionError(f"the MV explode did not take the computed-key instantiation: {v_seg}")
    refused = {}
    for name in MV_SEGMENT_ONLY:
        try:
            dist.query(queries[name])
        except NotImplementedError as err:
            refused[name] = str(err)
        else:
            raise AssertionError(f"the distributed engine answered {name}, which the JAX package refuses")
    records = {f"segment_engine/{k}": r for k, r in rec_seg.items()}
    records.update({f"dist_one_batch/{k}": r for k, r in rec_dist.items()})
    records["segment_engine/t_explode"]["exploded_rows_per_launch"] = MV_ROWS * width
    records["segment_engine/u_city_tags"]["exploded_rows_per_launch"] = MV_ROWS * width
    profiles = []
    for label, e, qs in (("segment_engine", engine, queries), ("dist_one_batch", dist, dist_q)):
        for name, sql in qs.items():
            records[f"{label}/{name}"].update(_wall_ms(e, sql))
            profiles.append(("index_profile", {"engine": label, "query": name}, e, sql))
    variants = dict(v_seg)
    for k, v in v_dist.items():
        variants[k] = variants.get(k, 0) + v
    log("index_mv_check", exact=True, fused_scan_launches={"segment_engine": n_seg, "dist_one_batch": n_dist},
        instantiations=variants, refused_by_dist=refused)
    return {"launches": n_seg + n_dist, "variants": variants, "records": records, "profiles": profiles,
            "engines": (engine, dist), "stacked": stacked}


def star_golden(datas):
    """Exact numpy answers of STAR_QUERIES (t1 is phase 4's (a))."""
    d = {k: np.concatenate([p[k] for p in datas]) for k in datas[0]}
    disc, q, rev = d["lo_discount"], d["lo_quantity"], d["lo_revenue"]
    m = q < 25
    s2 = np.zeros(11, np.int64)
    np.add.at(s2, disc[m], rev[m])
    c2 = np.bincount(disc[m], minlength=11)
    s3 = np.zeros(11, np.int64)
    np.add.at(s3, disc, rev)
    c3 = np.bincount(disc, minlength=11)
    mn = np.full(11, np.iinfo(np.int64).max)
    mx = np.full(11, np.iinfo(np.int64).min)
    np.minimum.at(mn, disc, rev)
    np.maximum.at(mx, disc, rev)
    return {
        "t2_discount_sum": [(i, float(s2[i]), int(c2[i])) for i in np.nonzero(c2)[0]],
        "t3_discount_extremes": [(i, float(mn[i]), float(mx[i]), s3[i] / c3[i]) for i in np.nonzero(c3)[0]],
        "t4_totals": [(float(rev.sum()), len(rev), float(rev.min()), float(rev.max()))],
    }


def _star_exact(name, got, want) -> bool:
    got = sorted(tuple(r) for r in got)
    if len(got) != len(want):
        return False
    for g, w in zip(got, want):
        if name == "t3_discount_extremes":
            if g[:3] != w[:3] or abs(g[3] - w[3]) > STAR_RTOL * abs(w[3]):
                return False
        elif g != tuple(w):
            return False
    return True


def _index_star(seg):
    """BASELINE config 4: new segments built by build_segment from phase 4's
    own arrays with the star-tree config (the levels are built on the host,
    as the builder builds everything else); every query of STAR_QUERIES
    with the tree and with SET useStarTree=false, both exact against the
    goldens, the star run scanning the right level's rows."""
    import dataclasses

    from pinot_tpu_torch.query.engine import QueryEngine
    from pinot_tpu_torch.segment.builder import build_segment

    state = seg["engine"].table("lineorder")
    cfg = dataclasses.replace(state.config, indexing=dataclasses.replace(
        state.config.indexing, star_tree_index_configs=[STAR_CFG]))
    engine = QueryEngine()
    engine.register_table(state.schema, cfg)
    # the same build without the tree, once, so the levels' share shows
    t0 = time.perf_counter()
    build_segment(state.schema, dict(seg["datas"][0]), "lineorder_plain", table_config=state.config)
    plain_build_s = time.perf_counter() - t0
    build_s, level_rows = [], {}
    for i, d in enumerate(seg["datas"]):
        t0 = time.perf_counter()
        s = build_segment(state.schema, dict(d), f"lineorder_star_{i}", table_config=cfg)
        build_s.append(time.perf_counter() - t0)
        if "st0" not in s.indexes.get("startree", {}):
            raise AssertionError(f"no star-tree built on {s.name}")
        for k, lvl in s.indexes["startree"]["st0"].levels.items():
            level_rows.setdefault(k, []).append(lvl.num_rows)
        engine.add_segment("lineorder", s)
    golden = star_golden(seg["datas"])
    golden["t1_config2"] = seg["golden"]["a_config2"]
    log("index_star_setup", segments=len(build_s), rows=sum(s.num_docs for s in state.segments),
        split_order=STAR_CFG["dimensionsSplitOrder"], pairs=STAR_CFG["functionColumnPairs"],
        segment_build_s_per_segment=build_s, plain_segment_build_s=plain_build_s,
        level_rows_per_segment={str(k): v for k, v in sorted(level_rows.items())})

    star_q = {name: sql for name, (sql, _k) in STAR_QUERIES.items()}
    scan_q = {name: "SET useStarTree=false; " + sql for name, sql in star_q.items()}
    n_star, v_star, rec_star = _index_counted_run(engine, star_q, golden, "star-tree", _star_exact)
    n_scan, v_scan, rec_scan = _index_counted_run(engine, scan_q, golden, "star-tree scan twin", _star_exact)
    for name, (_sql, k) in STAR_QUERIES.items():
        star, scan = rec_star[name], rec_scan[name]
        if not any(u[1] == "startree" for u in star["filter_index_uses"]):
            raise AssertionError(f"{name}: the star-tree did not serve the query: {star['filter_index_uses']}")
        if star["num_docs_scanned"] != sum(level_rows[k]) or not star["num_docs_scanned"] < scan["num_docs_scanned"]:
            raise AssertionError(f"{name}: star scanned {star['num_docs_scanned']} (level {k}: {sum(level_rows[k])}), "
                                 f"scan {scan['num_docs_scanned']}")
        star["level"] = k
    records = {f"star/{k}": r for k, r in rec_star.items()}
    records.update({f"scan/{k}": r for k, r in rec_scan.items()})
    profiles = []
    for label, qs in (("star", star_q), ("scan", scan_q)):
        for name, sql in qs.items():
            records[f"{label}/{name}"].update(_wall_ms(engine, sql))
            profiles.append(("index_profile", {"engine": f"segment_engine_{label}", "query": name}, engine, sql))
    variants = dict(v_star)
    for k, v in v_scan.items():
        variants[k] = variants.get(k, 0) + v
    log("index_star_check", exact=True, fused_scan_launches={"star": n_star, "scan": n_scan}, instantiations=variants)
    return {"launches": n_star + n_scan, "variants": variants, "records": records, "profiles": profiles,
            "engine": engine}


def text_part(rng):
    """One segment's TEXT_VALUES distinct bodies and JSON docs, and its
    rows' picks of them: a body is 4 words that spell its index in base 16
    (distinct by construction) and 2 random words, over 64 words that
    include TEXT_WORDS."""
    words = np.array(TEXT_WORDS + [f"w{i:02d}" for i in range(64 - len(TEXT_WORDS))], dtype=object)
    perm = rng.permutation(64)
    i = np.arange(TEXT_VALUES)
    idx = np.stack([perm[g * 16 + ((i >> (4 * g)) & 15)] for g in range(4)]
                   + [rng.integers(0, 64, TEXT_VALUES) for _ in range(2)], axis=1)
    idx = np.take_along_axis(idx, rng.random(idx.shape).argsort(axis=1), axis=1)  # shuffled word order
    bodies = [" ".join(words[r]) for r in idx]
    tiers = rng.integers(0, 3, TEXT_VALUES)
    events = rng.integers(0, 3, TEXT_VALUES)
    scores = np.round(rng.random(TEXT_VALUES) * 10, 2)
    docs = [{"user": {"id": int(k), "tier": ("free", "pro", "ent")[int(tiers[k])]},
             "events": [{"kind": "click"}] * int(events[k]), "score": float(scores[k])} for k in range(TEXT_VALUES)]
    return {"bodies": np.array(bodies, dtype=object), "docs": docs,
            "metas": np.array([json.dumps(d) for d in docs], dtype=object),
            "body_of_row": rng.integers(0, TEXT_VALUES, TEXT_ROWS), "meta_of_row": rng.integers(0, TEXT_VALUES, TEXT_ROWS),
            "v": rng.integers(0, 100, TEXT_ROWS).astype(np.int32)}


def _index_text(seed):
    """The docs table: 4 segments with a JSON and a text index; each query
    exact against a per-value Python golden."""
    from pinot_tpu_torch.query.engine import QueryEngine
    from pinot_tpu_torch.segment.builder import build_segment
    from pinot_tpu_torch.spi.config import IndexingConfig, TableConfig
    from pinot_tpu_torch.spi.schema import DataType, FieldRole, FieldSpec, Schema

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    parts = [text_part(rng) for _ in range(TEXT_SEGMENTS)]
    gen_s = time.perf_counter() - t0
    schema = Schema("docs", [FieldSpec("meta", DataType.JSON), FieldSpec("body", DataType.STRING),
                             FieldSpec("v", DataType.INT, role=FieldRole.METRIC)])
    cfg = TableConfig("docs", indexing=IndexingConfig(json_index_columns=["meta"], text_index_columns=["body"]))
    engine = QueryEngine()
    engine.register_table(schema, cfg)
    t1 = time.perf_counter()
    for i, p in enumerate(parts):
        engine.add_segment("docs", build_segment(schema, {"meta": p["metas"][p["meta_of_row"]],
                                                          "body": p["bodies"][p["body_of_row"]], "v": p["v"]},
                                                 f"docs_{i}", table_config=cfg))
    build_s = time.perf_counter() - t1
    queries, golden = {}, {}
    for name, (pred, fn) in TEXT_QUERIES.items():
        queries[name] = f"SELECT COUNT(*), SUM(v) FROM docs WHERE {pred}"
        cnt, tot = 0, 0
        for p in parts:
            rows = np.array([fn(d, b) for d, b in zip(p["docs"], p["bodies"])], dtype=bool)
            rows = rows[p["body_of_row"]] if name.startswith("x") else rows[p["meta_of_row"]]
            cnt += int(rows.sum())
            tot += int(p["v"][rows].sum())
        golden[name] = [(cnt, float(tot) if cnt else None)]  # SUM over no row is NULL
    log("index_text_setup", segments=TEXT_SEGMENTS, rows=TEXT_SEGMENTS * TEXT_ROWS,
        distinct_values_per_segment=TEXT_VALUES, generate_s=gen_s, segment_build_s=build_s,
        setup_s=time.perf_counter() - t0)
    n, _v, rec = _index_counted_run(engine, queries, golden, "text/json",
                                    lambda name, got, want: [tuple(r) for r in got] == want)
    for name, r in rec.items():
        want_use = ["meta", "json"] if name.startswith("j") else ["body", "text"]
        if want_use not in r["filter_index_uses"]:
            raise AssertionError(f"{name}: no {want_use[1]} index use: {r['filter_index_uses']}")
    records, profiles = {}, []
    for name, sql in queries.items():
        rec[name].update(_wall_ms(engine, sql))
        records[f"segment_engine/{name}"] = rec[name]
    for name in ("j1_tier", "x2_or_not"):
        profiles.append(("index_profile", {"engine": "segment_engine", "query": name}, engine, queries[name]))
    log("index_text_check", exact=True, fused_scan_launches=n)
    return {"launches": n, "records": records, "profiles": profiles, "engine": engine}


def _vector_sql(q, k, filt):
    qs = json.dumps([float(x) for x in q])
    return (f"SELECT id FROM vec WHERE VECTOR_SIMILARITY(embedding, '{qs}', {k})"
            f"{' AND v > 50' if filt else ''} LIMIT 5000")


def _index_vector(dev, seed):
    """One segment of VEC_ROWS x VEC_DIM float32 embeddings with a vector
    index: VECTOR_SIMILARITY at k = 10 and 1000, alone and AND v > 50, the
    selected ids held against a float64 numpy golden (rows within VEC_ATOL
    of the k-th score may go either way); the matrix-vector product timed
    against its byte bound."""
    from pinot_tpu_torch.indexes.vector import similarity_mask
    from pinot_tpu_torch.query.engine import QueryEngine
    from pinot_tpu_torch.segment.builder import RaggedColumn, build_segment
    from pinot_tpu_torch.spi.config import IndexingConfig, TableConfig
    from pinot_tpu_torch.spi.schema import DataType, FieldRole, FieldSpec, Schema

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    mat = rng.standard_normal((VEC_ROWS, VEC_DIM), dtype=np.float32)
    v = rng.integers(0, 100, VEC_ROWS).astype(np.int32)
    q = (mat[VEC_ROWS // 3] + 0.5 * rng.standard_normal(VEC_DIM, dtype=np.float32)).astype(np.float32)
    schema = Schema("vec", [FieldSpec("id", DataType.INT, role=FieldRole.METRIC),
                            FieldSpec("v", DataType.INT, role=FieldRole.METRIC),
                            FieldSpec("embedding", DataType.FLOAT, single_value=False)])
    cfg = TableConfig("vec", indexing=IndexingConfig(vector_index_columns=["embedding"]))
    t1 = time.perf_counter()
    segv = build_segment(schema, {"id": np.arange(VEC_ROWS, dtype=np.int32), "v": v,
                                  "embedding": RaggedColumn(mat.reshape(-1), np.full(VEC_ROWS, VEC_DIM, np.int32))},
                         "vec_0", table_config=cfg)
    build_s = time.perf_counter() - t1
    engine = QueryEngine()
    engine.register_table(schema, cfg)
    engine.add_segment("vec", segv)
    # float64 golden scores, in chunks
    q64 = q.astype(np.float64) / np.linalg.norm(q.astype(np.float64))
    scores = np.concatenate([
        (lambda c: (c @ q64) / np.linalg.norm(c, axis=1))(mat[i: i + (1 << 17)].astype(np.float64))
        for i in range(0, VEC_ROWS, 1 << 17)])
    ranked = np.sort(scores)[::-1]
    log("index_vector_setup", rows=VEC_ROWS, dim=VEC_DIM, matrix_bytes=mat.nbytes, segment_build_s=build_s,
        setup_s=time.perf_counter() - t0)

    from pinot_tpu_torch.ops import fused_scan

    fused_scan.LAUNCHES = 0
    records, profiles = {}, []
    for name, k, filt in VEC_CASES:
        sql = _vector_sql(q, k, filt)
        t1 = time.perf_counter()
        res = engine.query(sql)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t1) * 1e3
        got = np.array(sorted(int(r[0]) for r in res.rows), dtype=np.int64)
        kth = ranked[k - 1]
        keep = (v > 50) if filt else np.ones(VEC_ROWS, dtype=bool)
        sure_in = np.nonzero((scores > kth + VEC_ATOL) & keep)[0]
        sure_out = (scores < kth - VEC_ATOL) | ~keep
        exact = bool(np.isin(sure_in, got).all() and not sure_out[got].any())
        records[f"segment_engine/{name}"] = {
            "first_ms": first_ms, "rows": len(got), "sure_in": len(sure_in),
            "near_kth": int(((np.abs(scores - kth) <= VEC_ATOL) & keep).sum()), "exact": exact,
            "filter_index_uses": [list(u) for u in res.stats.filter_index_uses]}
        if not exact:
            raise AssertionError(f"vector {name}: the selected ids differ from the float64 golden")
        if ["embedding", "vector"] not in records[f"segment_engine/{name}"]["filter_index_uses"]:
            raise AssertionError(f"vector {name}: no vector index use")
        records[f"segment_engine/{name}"].update(_wall_ms(engine, sql))
        profiles.append(("index_profile", {"engine": "segment_engine", "query": name}, engine, sql))
    # the matrix-vector product alone, and the whole predicate, on the
    # segment's resident embedding rows
    vals = segv.to_device(dev, ["embedding"])["embedding"]["values"]
    vidx = segv.indexes["vector"]["embedding"]
    qt = torch.from_numpy(vidx.normalize_query(q)).to(dev)
    flush = _flushes(dev)["write"]
    mv_ms = _time_cuda(lambda: torch.mv(vals, qt), flush)
    mask_ms = _time_cuda(lambda: similarity_mask(vals, qt, vidx.dim, 1000), flush)
    bound_ms = VEC_ROWS * VEC_DIM * 4 / HBM_BYTES_PER_S * 1e3
    timing = {"mv_ms": mv_ms, "similarity_mask_ms": mask_ms, "bound_ms": bound_ms, "bound_by": "bytes",
              "mv_share_of_bound": bound_ms / mv_ms, "fused_scan_launches": fused_scan.LAUNCHES}
    log("index_vector_check", exact=True, **timing)
    return {"launches": fused_scan.LAUNCHES, "records": records, "profiles": profiles, "timing": timing,
            "engine": engine}


def phase_index_path(seg, dev, seed):
    """Phase 4f: the MV table on both engines, the star-tree on phase 4's
    lineorder rows, the text/JSON table and the vector segment; every
    result against its numpy golden.  Returns the launches, records and
    the profiles to run."""
    t0 = time.perf_counter()
    mv = _index_mv(dev, seed)
    star = _index_star(seg)
    text = _index_text(seed + 1)
    vec = _index_vector(dev, seed + 2)
    records = {f"mv/{k}": r for k, r in mv["records"].items()}
    records.update({f"startree/{k}": r for k, r in star["records"].items()})
    records.update({f"text/{k}": r for k, r in text["records"].items()})
    records.update({f"vector/{k}": r for k, r in vec["records"].items()})
    variants = dict(mv["variants"])
    for k, v in star["variants"].items():
        variants[k] = variants.get(k, 0) + v
    launches = mv["launches"] + star["launches"] + text["launches"] + vec["launches"]
    log("index_check", exact=True, fused_scan_launches={"mv": mv["launches"], "startree": star["launches"],
                                                        "text": text["launches"], "vector": vec["launches"]},
        index_s=time.perf_counter() - t0)
    return {"launches": launches, "variants": variants, "records": records,
            "profiles": mv["profiles"] + star["profiles"] + text["profiles"] + vec["profiles"],
            "vector": vec["timing"], "mv_dist": mv["engines"][1]}


# ---------------------------------------------------------------------------
# phase 4g: front_door — GAPFILL, IN (SELECT ...), set operations, EXPLAIN /
# EXPLAIN ANALYZE, trace spans, the timeseries engine and the safety rails,
# on the tables phases 4 and 4b built
# ---------------------------------------------------------------------------
FD_WHERE = "WHERE lo_quantity < 25 AND MOD(lo_orderdate, 10) <> 3"
FD_TOP_DAYS = ("SELECT lo_orderdate FROM lineorder WHERE lo_quantity < 25 GROUP BY lo_orderdate "
               "ORDER BY SUM(lo_revenue) DESC LIMIT 100")
FD_SET_A = ("SELECT lo_discount, lo_quantity FROM lineorder WHERE lo_revenue > 999990 "
            "GROUP BY lo_discount, lo_quantity LIMIT 1000")
FD_SET_B = ("SELECT lo_discount, lo_quantity FROM lineorder WHERE lo_orderdate < 19920301 AND lo_quantity < 10 "
            "GROUP BY lo_discount, lo_quantity LIMIT 1000")
FD_PIPELINE = ("fetch table=lineorder value=lo_revenue agg=sum tags=lo_discount time=lo_orderdate "
               "filter='lo_quantity < 25' | sumSeries | scale 2")
FD_BUCKETS = (19920101, 30, 81)
FRONT_DOOR_QUERIES = {
    "y1_gapfill_previous": ("SELECT GAPFILL(lo_orderdate, 19920101, 19922507, 1, FILL(SUM(lo_revenue), "
                            f"'FILL_PREVIOUS_VALUE')), SUM(lo_revenue) FROM lineorder {FD_WHERE} "
                            "GROUP BY lo_orderdate LIMIT 3000"),
    "y1_gapfill_null": ("SELECT GAPFILL(lo_orderdate, 19920101, 19922507, 1), SUM(lo_revenue) FROM lineorder "
                        f"{FD_WHERE} GROUP BY lo_orderdate LIMIT 3000"),
    "y2_in_subquery": (f"SELECT lo_discount, SUM(lo_revenue), COUNT(*) FROM lineorder WHERE lo_orderdate IN "
                       f"({FD_TOP_DAYS}) GROUP BY lo_discount ORDER BY lo_discount LIMIT 20"),
    "y2_not_in_subquery": (f"SELECT lo_discount, SUM(lo_revenue), COUNT(*) FROM lineorder WHERE lo_orderdate NOT IN "
                           f"({FD_TOP_DAYS}) GROUP BY lo_discount ORDER BY lo_discount LIMIT 20"),
    "y3_union_all": f"{FD_SET_A} UNION ALL {FD_SET_B}",
    "y3_union": f"{FD_SET_A} UNION {FD_SET_B}",
    "y3_intersect": f"{FD_SET_A} INTERSECT {FD_SET_B}",
    "y3_except": f"{FD_SET_A} EXCEPT {FD_SET_B}",
    "y4_explain": "EXPLAIN PLAN FOR " + CONFIG2,
    "y4_explain_analyze": "EXPLAIN ANALYZE " + CONFIG2,
    "y5_trace": "SET trace = true; " + CONFIG2,
    "y6_timeseries": FD_PIPELINE,
}
# what the distributed engine runs (the others it refuses, ROADMAP Queue 3)
FRONT_DOOR_DIST = ("y1_gapfill_previous", "y1_gapfill_null", "y5_trace", "y6_timeseries")
FRONT_DOOR_DIST_REFUSED = ("y2_in_subquery", "y3_union", "y4_explain")
# fused-scan launches a query makes: on the segment engine a multiple of its
# segments (one launch a segment a component; EXPLAIN none), on the
# distributed engine one at one launch
FRONT_DOOR_SEG_SCANS = {"y1_gapfill_previous": 1, "y1_gapfill_null": 1, "y2_in_subquery": 2,
                        "y2_not_in_subquery": 2, "y3_union_all": 2, "y3_union": 2, "y3_intersect": 2,
                        "y3_except": 2, "y4_explain": 0, "y4_explain_analyze": 1, "y5_trace": 1,
                        "y6_timeseries": 1}


class _Pipeline:
    """An engine for the timeseries pipeline: `.query(text)` runs the
    pipeline over FD_BUCKETS through TimeSeriesEngine (what the counted run,
    _wall_ms and profile_query call); the fetch's SQL and its result are
    kept."""

    def __init__(self, engine):
        from pinot_tpu_torch.timeseries import TimeBuckets, TimeSeriesEngine

        self.engine, self.buckets, self.sql, self.fetched = engine, TimeBuckets(*FD_BUCKETS), None, None
        self.ts = TimeSeriesEngine(self)

    def query(self, text):
        from pinot_tpu_torch.timeseries import parse_pipeline

        if text.startswith("fetch"):
            return self.ts.execute(parse_pipeline(text), self.buckets)
        self.sql, self.fetched = text, self.engine.query(text)  # the fetch's SQL group-by
        return self.fetched


def front_door_golden(parts):
    """Exact numpy answers of y1-y6 over the table whose columns `parts`
    hold (phase 4's 8 segments, or phase 4b's one table)."""
    day0, ndays = 19920101, 2406
    sums = np.zeros(ndays)
    cnts = np.zeros(ndays, np.int64)
    fsum = np.zeros(ndays)
    fcnt = np.zeros(ndays, np.int64)
    set_a, set_b = set(), set()
    disc_sum_by_day = np.zeros((ndays, 11))
    disc_cnt_by_day = np.zeros((ndays, 11), np.int64)
    ts = np.zeros(FD_BUCKETS[2])
    for d in parts:
        od = d["lo_orderdate"] - day0
        q, disc, rev = d["lo_quantity"], d["lo_discount"], d["lo_revenue"]
        m = q < 25
        sums += np.bincount(od[m], weights=rev[m], minlength=ndays)
        cnts += np.bincount(od[m], minlength=ndays)
        mf = m & ((od + day0) % 10 != 3)
        fsum += np.bincount(od[mf], weights=rev[mf], minlength=ndays)
        fcnt += np.bincount(od[mf], minlength=ndays)
        k = od.astype(np.int64) * 11 + disc
        disc_sum_by_day += np.bincount(k, weights=rev, minlength=ndays * 11).reshape(ndays, 11)
        disc_cnt_by_day += np.bincount(k, minlength=ndays * 11).reshape(ndays, 11)
        ka = np.unique(disc[rev > 999990].astype(np.int64) * 64 + q[rev > 999990])
        mb = (od < 19920301 - day0) & (q < 10)
        kb = np.unique(disc[mb].astype(np.int64) * 64 + q[mb])
        set_a.update((int(x // 64), int(x % 64)) for x in ka)
        set_b.update((int(x // 64), int(x % 64)) for x in kb)
        ts += 2.0 * np.bincount(od[m] // FD_BUCKETS[1], weights=rev[m], minlength=FD_BUCKETS[2])[:FD_BUCKETS[2]]
    prev_rows, null_rows, last = [], [], None
    for b in range(ndays):
        if fcnt[b]:
            last = float(fsum[b])
            prev_rows.append((day0 + b, last))
            null_rows.append((day0 + b, last))
        else:
            prev_rows.append((day0 + b, last))
            null_rows.append((day0 + b, None))
    order = np.argsort(-sums, kind="stable")
    if sums[order[99]] == sums[order[100]]:
        raise AssertionError("the top-100 days tie at the cut: the IN (SELECT ...) golden is ambiguous")
    top = np.zeros(ndays, bool)
    top[order[:100]] = True

    def by_disc(sel):
        s, c = disc_sum_by_day[sel].sum(axis=0), disc_cnt_by_day[sel].sum(axis=0)
        return [(int(i), float(s[i]), int(c[i])) for i in range(11) if c[i]]

    config2 = sorted((day0 + int(i), float(sums[i]), int(cnts[i])) for i in np.nonzero(cnts)[0])
    return {
        "y1_gapfill_previous": prev_rows, "y1_gapfill_null": null_rows,
        "y2_in_subquery": by_disc(top), "y2_not_in_subquery": by_disc(~top),
        "y3_union_all": sorted(set_a) + sorted(set_b), "y3_union": sorted(set_a | set_b),
        "y3_intersect": sorted(set_a & set_b), "y3_except": sorted(set_a - set_b),
        "y5_trace": config2, "y6_timeseries": ts,
        "gap_days": int((fcnt == 0).sum()),
    }


def _front_door_exact(name, res, want) -> bool:
    if name == "y6_timeseries":
        return list(res.series) == [()] and np.array_equal(res.series[()], want)
    if name.startswith("y3_"):
        return sorted(map(tuple, res.rows)) == sorted(want)
    if name in ("y5_trace",):
        return sorted(res.rows) == want
    return list(res.rows) == want


def _check_explain(res, launches, analyzed=None):
    """EXPLAIN PLAN FOR config 2: the operator tree, no launch, no doc;
    EXPLAIN ANALYZE (`analyzed`): the same operators, measured, 8 launch
    spans, the analytic bytes, a Roofline_Pct within 100."""
    ops = [r[0] for r in res.rows]
    want = ["BROKER_REDUCE(limit)", "COMBINE_GROUPBY_DENSE", "GROUP_BY(keys: lo_orderdate; dense table 2406)",
            "PROJECT(lo_orderdate, lo_revenue)", "FILTER_INDEX(lo_quantity:range)"]
    if analyzed is None:
        if ops != want or launches != 0 or res.stats.num_docs_scanned != 0:
            raise AssertionError(f"EXPLAIN PLAN FOR: {ops}, {launches} launches, "
                                 f"{res.stats.num_docs_scanned} docs")
        return {"operators": ops}
    from pinot_tpu_torch.query.analyze import ANALYZE_COLUMNS

    rows = {r[0]: r for r in res.rows}
    spans = [r for r in res.rows if r[0].startswith("TRACE(launch:")]
    group = rows[want[2]]
    roofs = [rows[op][7] for op in want[1:3]]
    if (res.columns != ANALYZE_COLUMNS or ops[:5] != want or len(spans) != analyzed or launches != analyzed
            or rows[want[0]][4] != 2406 or group[5] != sum(r[5] for r in spans) or not group[5]
            or any(r is None or not 0.0 < r <= 100.0 for r in roofs)
            or any("costSource=analytic" not in r[0] for r in spans)):
        raise AssertionError(f"EXPLAIN ANALYZE: {res.rows[:6]}, {launches} launches")
    return {"operators": ops[:5], "actual_ms": {op: rows[op][3] for op in want}, "bytes": group[5],
            "flops": group[6], "roofline_pct": roofs, "launch_spans": len(spans)}


def _check_trace(trace, is_seg, segments):
    names = [c["name"] for c in trace["children"]]
    if is_seg:
        ok = (sum(n.startswith("launch:") for n in names) == segments and names.count("collect") == segments
              and names.count("device_wait") == 1 and names.count("reduce") == 1)
    else:
        ok = names == ["plan", "run", "reduce"]
    if not ok:
        raise AssertionError(f"trace spans: {names}")
    wait = next((c for c in trace["children"] if c["name"] == "device_wait"), None)
    bases = [n.split(":")[0] for n in names]
    out = {"spans": {b: bases.count(b) for b in dict.fromkeys(bases)}}
    if wait is not None:
        out.update(device_wait_ms=wait["ms"], device_span_ms=wait["attrs"].get("deviceMs"),
                   roofline_pct=wait["attrs"].get("rooflinePct"))
    else:
        out["plan_attrs"] = trace["children"][0].get("attrs")
    return out


def _front_door_counted_run(label, engine, names, golden_rows, segments):
    """Each query once, the fused scan's counters set to 0 just before and
    read just after; every answer against its golden and its launch count
    (`segments` launches a component on the segment engine, one on the
    distributed engine at one launch).  Returns the launches, the
    instantiations, the records and the results."""
    from pinot_tpu_torch.ops import fused_scan
    from pinot_tpu_torch.query import planner
    from pinot_tpu_torch.sql.parser import parse_query

    is_seg = label.startswith("segment")
    fused_scan.LAUNCHES = 0
    fused_scan.VARIANT_LAUNCHES.clear()
    out, results = {}, {}
    for name in names:
        before, vbefore = fused_scan.LAUNCHES, dict(fused_scan.VARIANT_LAUNCHES)
        e = _Pipeline(engine) if name == "y6_timeseries" else engine
        t0 = time.perf_counter()
        res = e.query(FRONT_DOOR_QUERIES[name])
        torch.cuda.synchronize()
        n = fused_scan.LAUNCHES - before
        rec = {"first_ms": (time.perf_counter() - t0) * 1e3, "fused_scan_launches": n,
               "instantiations": {k: v - vbefore.get(k, 0) for k, v in fused_scan.VARIANT_LAUNCHES.items()
                                  if v != vbefore.get(k, 0)}}
        if name == "y4_explain":
            rec.update(_check_explain(res, n))
        elif name == "y4_explain_analyze":
            rec.update(_check_explain(res, n, analyzed=segments))
        else:
            if not _front_door_exact(name, res, golden_rows[name]):
                got = res.series if name == "y6_timeseries" else list(res.rows)[:3]
                raise AssertionError(f"{label} {name} differs from the numpy golden: {got}")
            rec["rows"] = len(res.series[()]) if name == "y6_timeseries" else len(res.rows)
        rec["exact"] = True
        if name == "y5_trace":
            rec.update(_check_trace(res.stats.trace, is_seg, segments))
        if name == "y6_timeseries":
            ctx = parse_query(e.sql)
            table = engine.tables["lineorder"]
            plan = (planner.plan_segment(ctx, table.segments[0], engine.device) if is_seg
                    else engine._plan(ctx, table))
            rec.update(fetch_groups=len(e.fetched.rows), key_space=plan.num_groups)
        want = FRONT_DOOR_SEG_SCANS[name] * (segments if is_seg else 1)
        if n != want:
            raise AssertionError(f"{label} {name}: {n} fused-scan launches, want {want}")
        out[name], results[name] = rec, res
    return fused_scan.LAUNCHES, dict(fused_scan.VARIANT_LAUNCHES), out, results


def _front_door_safety(seg_engine):
    """(y7) A deadline that expires raises QueryTimeoutError; a 1 MiB
    accountant refuses config 2 with AdmissionError before any launch; the
    accountant holds 0 bytes after every query, the failed one too."""
    from pinot_tpu_torch.ops import fused_scan
    from pinot_tpu_torch.query import planner
    from pinot_tpu_torch.query.engine import QueryEngine
    from pinot_tpu_torch.query.safety import AdmissionError, QueryTimeoutError, estimate_segment_bytes
    from pinot_tpu_torch.sql.parser import parse_query

    out = {}
    before = fused_scan.LAUNCHES
    try:
        seg_engine.query("SET timeoutMs = 1; " + CONFIG2)
    except QueryTimeoutError as err:
        out["timeout"] = str(err)
    else:
        raise AssertionError("a 1 ms deadline did not expire on config 2")
    torch.cuda.synchronize()
    out["timeout_launches"] = fused_scan.LAUNCHES - before
    if seg_engine.accountant.in_use != 0:
        raise AssertionError(f"the accountant holds {seg_engine.accountant.in_use} B after a failed query")
    state = seg_engine.table("lineorder")
    small = QueryEngine(memory_budget_bytes=1 << 20)
    small.register_table(state.schema, state.config)
    for s in state.segments:
        small.add_segment("lineorder", s)
    before = fused_scan.LAUNCHES
    try:
        small.query(CONFIG2)
    except AdmissionError as err:
        out["admission"] = str(err)
    else:
        raise AssertionError("a 1 MiB budget admitted config 2")
    out["admission_launches"] = fused_scan.LAUNCHES - before
    if out["admission_launches"] != 0 or small.accountant.in_use != 0:
        raise AssertionError(f"the refused query launched or held bytes: {out}")
    ctx = parse_query(CONFIG2)
    out["config2_estimate_bytes"] = sum(estimate_segment_bytes(ctx, s, planner._needed_columns(ctx, s))
                                        for s in state.segments)
    out["budget_bytes"] = seg_engine.accountant.budget
    return out


def _front_door_host(seg_engine, gapfill_result):
    """DDL through engine.sql, a ResponseStore paging (y1)'s rows, and the
    slow-query log's entries (host only)."""
    from pinot_tpu_torch.query.cursors import ResponseStore

    ddl = "CREATE TABLE fd_ddl (k INT, city STRING, v LONG METRIC NULLABLE) WITH (invertedIndexColumns = 'city')"
    shown = [seg_engine.sql(ddl).rows, seg_engine.sql("SHOW TABLES").rows,
             seg_engine.sql("SHOW CREATE TABLE fd_ddl").rows[0][0], seg_engine.sql("DROP TABLE fd_ddl").rows,
             seg_engine.sql("SHOW TABLES").rows]
    want_text = ("CREATE TABLE fd_ddl (\n  k INT,\n  city STRING,\n  v LONG METRIC NULLABLE\n) WITH (\n"
                 "  invertedIndexColumns = 'city'\n)")
    if shown[1] != [("fd_ddl",), ("lineorder",)] or shown[2] != want_text or shown[4] != [("lineorder",)]:
        raise AssertionError(f"DDL round trip: {shown}")
    store = ResponseStore()
    cid = store.register(gapfill_result, page_size=500)
    pages = [store.fetch(cid, p) for p in range(store.fetch(cid, 0)["numPages"])]
    if [tuple(r) for p in pages for r in p["rows"]] != list(gapfill_result.rows):
        raise AssertionError("the ResponseStore pages differ from the result")
    store.delete(cid)
    snap = seg_engine.slow_queries.snapshot()
    return {"ddl": {"created": shown[0], "tables": shown[1], "dropped": shown[3]},
            "cursor": {"pages": len(pages), "rows": sum(len(p["rows"]) for p in pages)},
            "slow_log": {"entries": len(snap), "errors": sum("error" in e for e in snap),
                         "slow": sum("trace" in e for e in snap),
                         "newest": [{"sql": e["sql"][:80], **{k: e.get(k) for k in (
                             "timeMs", "rows", "costSource", "rooflinePct", "error")}} for e in snap[:3]]}}


def phase_front_door(seg, dist):
    """Phase 4g: y1-y7 on the segment engine's 8 x 2^23 rows and y1, y5, y6
    on the distributed engine's 2^27 rows at one launch (its three
    refusals recorded); every answer against its numpy golden and its
    launch count; the safety rails and the host-only pieces; then warm
    medians of 5.  Returns the launches, the records and the profiles to
    run (one session each)."""
    t0 = time.perf_counter()
    seg_golden = front_door_golden(seg["datas"])
    dist_golden_rows = front_door_golden([dist["data"]])
    log("front_door_setup", golden_s=time.perf_counter() - t0, gap_days={"segment": seg_golden["gap_days"],
                                                                        "dist": dist_golden_rows["gap_days"]})
    engine, engine_d = seg["engine"], dist["engines"]["one_batch"]
    nseg = len(seg["datas"])
    runs = [("segment_engine", engine, list(FRONT_DOOR_QUERIES), seg_golden),
            ("dist_one_batch", engine_d, list(FRONT_DOOR_DIST), dist_golden_rows)]
    records, launches, variants, profiles, seg_results = {}, 0, {}, [], None
    for label, e, names, golden_rows in runs:
        nl, nv, per, results = _front_door_counted_run(label, e, names, golden_rows, nseg)
        launches += nl
        seg_results = seg_results or results
        for k, v in nv.items():
            variants[k] = variants.get(k, 0) + v
        records.update({f"{label}/{k}": r for k, r in per.items()})
    refused = {}
    for name in FRONT_DOOR_DIST_REFUSED:
        try:
            engine_d.query(FRONT_DOOR_QUERIES[name])
        except NotImplementedError as err:
            refused[name] = str(err)
        else:
            raise AssertionError(f"the distributed engine answered {name}, which it refuses (ROADMAP Queue 3)")
    safety = _front_door_safety(engine)
    launches += safety["timeout_launches"]
    host = _front_door_host(engine, seg_results["y1_gapfill_previous"])
    if engine.accountant.in_use != 0:
        raise AssertionError(f"the accountant holds {engine.accountant.in_use} B after the phase")
    log("front_door_check", exact=True, launches=launches, instantiations=variants, refused_by_dist=refused,
        safety=safety, **host)
    for label, e, names, _g in runs:
        for name in names:
            runner = _Pipeline(e) if name == "y6_timeseries" else e
            records[f"{label}/{name}"].update(_wall_ms(runner, FRONT_DOOR_QUERIES[name]))
            profiles.append(("front_door_profile", {"engine": label, "query": name}, runner,
                             FRONT_DOOR_QUERIES[name]))
    return {"launches": launches, "variants": variants, "records": records, "profiles": profiles,
            "front_door_s": time.perf_counter() - t0, "seg_golden": seg_golden}


# ---------------------------------------------------------------------------
# phase 4h: join_path — the multi-stage join engine (BASELINE config 5) over
# phase 4b's 2^27-row lineorder and SSB-shaped dimensions
# ---------------------------------------------------------------------------
JOIN_DAY0 = 19920101
JOIN_DAYS = 2556  # one row a day, 1992-01-01 .. 1998-12-31 (SSB's DATE table)
JOIN_EARLY_YEARS = 5  # dates_early: 1992-1996
# phase 4's segments that make the 2^24-row table of (z8) and (z9)
JOIN_SMALL_SEGMENTS = 2
JOIN_ERAS = {1992: "early90s", 1993: "early90s", 1994: "mid90s", 1995: "mid90s", 1996: "mid90s",
             1997: "late90s", 1998: "late90s"}
JOIN_CHANNELS = np.asarray(["web", "mail", "store", "tv"])
JOIN_Z1 = ("SELECT d_year, SUM(lo_revenue), COUNT(*) FROM lineorder JOIN dates ON lo_orderdate = d_datekey "
           "WHERE lo_quantity < 25 GROUP BY d_year")
JOIN_QUERIES = {  # (sql, engine table set, fused-scan launches one run makes)
    "z1_config5": (JOIN_Z1, "big", 1),
    "z2_shuffle": ("SET joinStrategy = 'shuffle'; " + JOIN_Z1, "big", 1),
    "z3_q1_1": ("SELECT SUM(lo_revenue * lo_discount) FROM lineorder JOIN dates ON lo_orderdate = d_datekey "
                "WHERE d_year = 1993 AND lo_discount BETWEEN 1 AND 3 AND lo_quantity < 25", "big", 0),
    "z4_season_discount": ("SELECT d_sellingseason, lo_discount, SUM(lo_revenue), COUNT(*) FROM lineorder "
                           "JOIN dates ON lo_orderdate = d_datekey WHERE lo_quantity < 25 "
                           "GROUP BY d_sellingseason, lo_discount LIMIT 100", "big", 1),
    "z5_left": ("SELECT d_year, SUM(lo_revenue), COUNT(*) FROM lineorder LEFT JOIN dates_early "
                "ON lo_orderdate = d_datekey WHERE lo_quantity < 25 GROUP BY d_year", "big", 1),
    "z6_snowflake": ("SELECT y_era, SUM(lo_revenue), COUNT(*) FROM lineorder JOIN dates ON lo_orderdate = d_datekey "
                     "JOIN years ON d_year = y_year WHERE lo_quantity < 25 GROUP BY y_era", "big", 1),
    "z7_selection": ("SELECT lo_orderdate, lo_revenue, d_yearmonthnum FROM lineorder JOIN dates "
                     "ON lo_orderdate = d_datekey WHERE lo_quantity = 1 ORDER BY lo_revenue DESC LIMIT 100",
                     "big", 0),
    "z8_many_to_many": ("SELECT p_channel, SUM(lo_revenue), COUNT(*) FROM lineorder JOIN promo "
                        "ON lo_discount = p_discount WHERE lo_quantity < 25 GROUP BY p_channel", "small", 1),
    "z9_overflow_retry": ("SET joinStrategy = 'shuffle'; SET shuffleSlack = 0.01; " + JOIN_Z1, "small", 1),
}
JOIN_CAP_SQL = "SET joinStrategy = 'shuffle'; SET shuffleSlack = 0.01; SET shuffleSlackCap = 0.01; " + JOIN_Z1


def join_dimensions():
    """The host columns of dates (SSB's DATE shape: 2556 days of 1992-1998,
    keyed as bench.py keys lo_orderdate), years and dates_early."""
    day = np.datetime64("1992-01-01") + np.arange(JOIN_DAYS)
    year = day.astype("datetime64[Y]").astype(np.int64) + 1970
    month = day.astype("datetime64[M]").astype(np.int64) % 12 + 1
    doy = (day - day.astype("datetime64[Y]")).astype(np.int64)
    season = np.asarray(["Winter", "Winter", "Spring", "Spring", "Spring", "Summer", "Summer", "Summer",
                         "Fall", "Fall", "Fall", "Christmas"])[month - 1]
    dates = {"d_datekey": (JOIN_DAY0 + np.arange(JOIN_DAYS)).astype(np.int32), "d_year": year.astype(np.int32),
             "d_yearmonthnum": (year * 100 + month).astype(np.int32),
             "d_weeknuminyear": (doy // 7 + 1).astype(np.int32), "d_sellingseason": season.astype(object)}
    years = {"y_year": np.arange(1992, 1999, dtype=np.int32),
             "y_era": np.asarray([JOIN_ERAS[y] for y in range(1992, 1999)], dtype=object)}
    early = year < 1992 + JOIN_EARLY_YEARS
    dates_early = {k: v[early] for k, v in dates.items()}
    # promo: 3 rows a discount (max_dup 3), channels (disc + j) % 4
    pd_ = np.repeat(np.arange(11, dtype=np.int32), 3)
    promo = {"p_discount": pd_, "p_channel": JOIN_CHANNELS[(pd_ + np.tile(np.arange(3), 11)) % 4].astype(object)}
    return dates, years, dates_early, promo


def _join_schemas():
    from pinot_tpu_torch.spi.schema import DataType, FieldSpec, Schema

    INT, STR = DataType.INT, DataType.STRING
    return {
        "dates": Schema("dates", [FieldSpec("d_datekey", INT), FieldSpec("d_year", INT),
                                  FieldSpec("d_yearmonthnum", INT), FieldSpec("d_weeknuminyear", INT),
                                  FieldSpec("d_sellingseason", STR)]),
        "years": Schema("years", [FieldSpec("y_year", INT), FieldSpec("y_era", STR)]),
        "promo": Schema("promo", [FieldSpec("p_discount", INT), FieldSpec("p_channel", STR)]),
    }


def join_golden(d, small, dims):
    """Exact numpy answers of (z1)-(z9): each join a lookup array indexed by
    lo_orderdate - 19920101 (promo's by lo_discount).  Group sums use
    np.bincount's float64 weights: every partial sum is an integer below
    2^53, so they are exact."""
    dates, _years, dates_early, promo = dims
    year_of = dates["d_year"].astype(np.int64)
    season_names, season_of = np.unique(dates["d_sellingseason"].astype(str), return_inverse=True)
    ym_of = dates["d_yearmonthnum"].astype(np.int64)
    n_early = len(dates_early["d_datekey"])

    def day_filter_revenue(t):
        od = np.asarray(t["lo_orderdate"]).astype(np.int64) - JOIN_DAY0
        return od, np.asarray(t["lo_quantity"]) < 25, np.asarray(t["lo_revenue"])

    out = {}
    od, m, rev = day_filter_revenue(d)
    disc = np.asarray(d["lo_discount"]).astype(np.int64)
    q = np.asarray(d["lo_quantity"])
    yi = year_of[od[m]] - 1992
    s = np.bincount(yi, weights=rev[m], minlength=7)
    c = np.bincount(yi, minlength=7)
    out["z1_config5"] = out["z2_shuffle"] = sorted((1992 + i, float(s[i]), int(c[i])) for i in range(7) if c[i])
    m3 = m & (year_of[od] == 1993) & (disc >= 1) & (disc <= 3)
    out["z3_q1_1"] = [(float(int((rev[m3].astype(np.int64) * disc[m3]).sum())),)]
    k4 = season_of[od[m]] * 11 + disc[m]
    s4 = np.bincount(k4, weights=rev[m], minlength=len(season_names) * 11)
    c4 = np.bincount(k4, minlength=len(season_names) * 11)
    out["z4_season_discount"] = sorted((str(season_names[k // 11]), int(k % 11), float(s4[k]), int(c4[k]))
                                       for k in np.nonzero(c4)[0])
    ye = np.where(od[m] < n_early, year_of[np.minimum(od[m], n_early - 1)] - 1992, JOIN_EARLY_YEARS)
    s5 = np.bincount(ye, weights=rev[m], minlength=JOIN_EARLY_YEARS + 1)
    c5 = np.bincount(ye, minlength=JOIN_EARLY_YEARS + 1)
    # years ascending, then the NULL slot (the order _null_last sorts rows in)
    out["z5_left"] = [((1992 + i) if i < JOIN_EARLY_YEARS else None, float(s5[i]), int(c5[i]))
                      for i in range(JOIN_EARLY_YEARS + 1) if c5[i]]
    eras = {}
    for i in range(7):
        e = JOIN_ERAS[1992 + i]
        es, ec = eras.get(e, (0.0, 0))
        eras[e] = (es + float(s[i]), ec + int(c[i]))
    out["z6_snowflake"] = sorted((e, es, ec) for e, (es, ec) in eras.items() if ec)
    i7 = np.nonzero(q == 1)[0]
    o7 = i7[np.argsort(-rev[i7], kind="stable")][: 100 + 4096]  # every row a tie at the end can reach
    out["z7_selection"] = _ordered_expect(
        (-rev[o7].astype(np.int64))[:, None],
        [(int(JOIN_DAY0 + od[j]), int(rev[j]), int(ym_of[od[j]])) for j in o7], 0, 100)
    # the 2^24-row table
    od2, m2, rev2 = day_filter_revenue(small)
    disc2 = np.asarray(small["lo_discount"]).astype(np.int64)
    ch_names = sorted(set(promo["p_channel"]))
    s8, c8 = np.zeros(len(ch_names)), np.zeros(len(ch_names), np.int64)
    sd = np.bincount(disc2[m2], weights=rev2[m2], minlength=11)
    cd = np.bincount(disc2[m2], minlength=11)
    for pdisc, ch in zip(promo["p_discount"], promo["p_channel"]):
        s8[ch_names.index(ch)] += sd[pdisc]
        c8[ch_names.index(ch)] += cd[pdisc]
    out["z8_many_to_many"] = sorted((ch, float(s8[i]), int(c8[i])) for i, ch in enumerate(ch_names) if c8[i])
    yi2 = year_of[od2[m2]] - 1992
    s9, c9 = np.bincount(yi2, weights=rev2[m2], minlength=7), np.bincount(yi2, minlength=7)
    out["z9_overflow_retry"] = sorted((1992 + i, float(s9[i]), int(c9[i])) for i in range(7) if c9[i])
    return out


def _join_exact(name, rows, want) -> bool:
    if name == "z7_selection":
        return _ordered_exact(list(rows), want)
    if name == "z3_q1_1":
        return list(rows) == want
    return sorted(rows, key=_null_last) == want


def _null_last(row):
    """Sort key of a result row whose first cell may be NULL (z5): NULL last."""
    return (row[0] is None, 0 if row[0] is None else row[0]) + tuple(row[1:])


def _join_counted_run(engines, golden_rows):
    """Each query once, the fused scan's counters set to 0 just before and
    read just after, with the peak device memory of the run; every answer
    against its golden, its launches and instantiation checked; the
    overflow retries of (z9) read from METRICS."""
    from pinot_tpu_torch.ops import fused_scan
    from pinot_tpu_torch.utils.metrics import METRICS

    fused_scan.LAUNCHES = 0
    fused_scan.VARIANT_LAUNCHES.clear()
    out = {}
    for name, (sql, part, want_launches) in JOIN_QUERIES.items():
        e = engines[part]
        before, vbefore = fused_scan.LAUNCHES, dict(fused_scan.VARIANT_LAUNCHES)
        retries = METRICS.counter("mse.exchangeOverflowRetries").value
        misses = e._mse().plan_misses
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        res = e.query(sql)
        torch.cuda.synchronize()
        n = fused_scan.LAUNCHES - before
        rec = {"first_ms": (time.perf_counter() - t0) * 1e3, "fused_scan_launches": n,
               "instantiations": {k: v - vbefore.get(k, 0) for k, v in fused_scan.VARIANT_LAUNCHES.items()
                                  if v != vbefore.get(k, 0)},
               "peak_allocated": torch.cuda.max_memory_allocated(), "peak_over_start": torch.cuda.max_memory_allocated()
               - base, "rows": len(res.rows), "groups": res.stats.num_groups,
               "index_uses": list(res.stats.filter_index_uses), "bytes_to_host": res.stats.bytes_to_host,
               "overflow_retries": METRICS.counter("mse.exchangeOverflowRetries").value - retries,
               "plans_built": e._mse().plan_misses - misses}
        if not _join_exact(name, res.rows, golden_rows[name]):
            raise AssertionError(f"join query {name} differs from the numpy golden: {list(res.rows)[:4]} vs "
                                 f"{golden_rows[name] if name != 'z7_selection' else golden_rows[name][0][:4]}")
        rec["exact"] = True
        if n != want_launches or (n and rec["instantiations"] != {"i32/i32/shared": n}):
            raise AssertionError(f"join query {name}: {n} fused-scan launches {rec['instantiations']}, "
                                 f"want {want_launches} of i32/i32/shared")
        if name == "z9_overflow_retry" and not (rec["overflow_retries"] > 0 and rec["plans_built"] > 1):
            raise AssertionError(f"(z9) did not retry the overflowing shuffle: {rec}")
        if name == "z7_selection" and not rec["bytes_to_host"]:
            raise AssertionError(f"(z7) copied nothing home: {rec}")
        out[name] = rec
    # the cap: with shuffleSlackCap at the starting slack the loop gives up
    before = fused_scan.LAUNCHES
    try:
        engines["small"].query(JOIN_CAP_SQL)
    except RuntimeError as err:
        if "shuffleSlackCap" not in str(err):
            raise
        out["z9_overflow_retry"]["cap_error"] = str(err)
    else:
        raise AssertionError("a shuffleSlackCap of 0.01 did not stop the overflowing shuffle")
    torch.cuda.synchronize()
    if fused_scan.LAUNCHES != before:
        raise AssertionError("the refused shuffle launched the fused scan")
    return fused_scan.LAUNCHES, dict(fused_scan.VARIANT_LAUNCHES), out


def phase_join_path(seg, dist):
    """Phase 4h: (z1)-(z9) through DistributedEngine() on CUDA, which routes
    them to the multi-stage engine: (z1)-(z7) over phase 4b's 2^27-row
    lineorder (not rebuilt) with dates, years and dates_early, (z8) and
    (z9) over a 2^24-row table built from phase 4's first two segments with
    promo and dates.  Every answer exact against numpy with its launches
    counted, then warm medians of 5; the profiles (one session each) run
    with the others.  Returns the launches, records and profiles."""
    from pinot_tpu_torch.parallel.engine import DistributedEngine
    from pinot_tpu_torch.parallel.stacked import StackedTable

    t0 = time.perf_counter()
    dims = join_dimensions()
    dates, years, dates_early, promo = dims
    schemas = _join_schemas()
    fact = dist["stacked"]
    datas = seg["datas"][:JOIN_SMALL_SEGMENTS]
    small = {k: np.concatenate([d[k] for d in datas]) for k in datas[0]}
    t1 = time.perf_counter()
    small_st = StackedTable.build(fact.schema, small, num_shards=1)
    small_build_s = time.perf_counter() - t1
    dim_tables = {"dates": StackedTable.build(schemas["dates"], dates, num_shards=1),
                  "years": StackedTable.build(schemas["years"], years, num_shards=1),
                  "dates_early": StackedTable.build(schemas["dates"], dates_early, num_shards=1),
                  "promo": StackedTable.build(schemas["promo"], promo, num_shards=1)}
    engines = {"big": DistributedEngine(), "small": DistributedEngine()}
    engines["big"].register_table("lineorder", fact)
    engines["small"].register_table("lineorder", small_st)
    for name, t in dim_tables.items():
        for e in engines.values():
            e.register_table(name, t)
    want = join_golden(dist["data"], small, dims)
    log("join_setup", fact_rows=fact.num_docs, small_rows=small_st.num_docs, small_build_s=small_build_s,
        dim_rows={k: t.num_docs for k, t in dim_tables.items()}, setup_and_golden_s=time.perf_counter() - t0)

    launches, variants, records = _join_counted_run(engines, want)
    log("join_check", exact=True, launches=launches, instantiations=variants,
        per_query={k: {f: r[f] for f in ("fused_scan_launches", "groups", "overflow_retries", "plans_built")}
                   for k, r in records.items()})
    profiles = []
    for name, (sql, part, _n) in JOIN_QUERIES.items():
        records[name].update(_wall_ms(engines[part], sql))
        profiles.append(("join_profile", {"engine": f"dist_{part}", "query": name}, engines[part], sql))
    return {"launches": launches, "variants": variants, "records": records, "profiles": profiles,
            "engines": engines, "join_s": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# phase 4i: realtime tables — consuming segments, upsert, restart, and the
# distributed engine over a compacted upsert table
# ---------------------------------------------------------------------------
# the JAX package's default segment end criterion (StreamConfig
# max_rows_per_segment), not cut
RT_SEGMENT_ROWS = 1 << 20
RT_R1_MESSAGES = (1 << 20) + (1 << 19)  # one sealed segment + a 2^19-row snapshot
RT_FRESH_CYCLES = 20
RT_FRESH_ROWS = 4096
RT_UPSERT_MESSAGES = (1 << 21) + (1 << 18)
RT_UPSERT_KEYS = 1 << 20
RT_UPSERT_PARTITIONS = 2
RT_MEMORY_SLACK = 64 << 20


def _rt_schema(upsert: bool):
    from pinot_tpu_torch.spi.schema import DataType, FieldRole, FieldSpec, Schema

    fields = [
        FieldSpec("lo_orderdate", DataType.INT),
        FieldSpec("lo_quantity", DataType.INT),
        FieldSpec("lo_discount", DataType.INT),
        FieldSpec("lo_revenue", DataType.LONG, role=FieldRole.METRIC),
    ]
    if not upsert:
        return Schema("lineorder", fields)
    return Schema("lineorder", fields + [FieldSpec("lo_orderkey", DataType.LONG),
                                         FieldSpec("ts", DataType.TIMESTAMP, role=FieldRole.DATE_TIME)],
                  primary_key_columns=["lo_orderkey"])


def _rt_config(upsert: bool):
    from pinot_tpu_torch.spi.config import IndexingConfig, SegmentsConfig, StreamConfig, TableConfig, UpsertConfig

    return TableConfig(
        "lineorder",
        indexing=IndexingConfig(range_index_columns=["lo_quantity"]),
        segments=SegmentsConfig(time_column="ts" if upsert else None),
        stream=StreamConfig(stream_type="memory", topic="lineorder", max_rows_per_segment=RT_SEGMENT_ROWS),
        upsert=UpsertConfig(mode="FULL", comparison_column="ts") if upsert else None,
    )


def _messages(d):
    """Column arrays -> one dict a row (the decoded stream payloads)."""
    names = list(d)
    return [dict(zip(names, r)) for r in zip(*(d[k].tolist() for k in names))]


def _config2_tables(d):
    """Config 2's per-day SUM(lo_revenue) and COUNT(*) of rows `d`, exact
    (float64 bincount sums of integers stay below 2^53)."""
    od, m = d["lo_orderdate"] - 19920101, d["lo_quantity"] < 25
    return (np.bincount(od[m], weights=d["lo_revenue"][m], minlength=2406),
            np.bincount(od[m], minlength=2406).astype(np.int64))


def _config2_rows(sums, cnts):
    return sorted((19920101 + int(i), float(sums[i]), int(cnts[i])) for i in np.nonzero(cnts)[0])


def _rt_counted(engine, want, label, expect_launches):
    """Config 2 once with the counts set to 0 just before and read just
    after; exact against `want`, launching the fused scan once a segment."""
    from pinot_tpu_torch.ops import fused_scan

    torch.cuda.synchronize()
    fused_scan.LAUNCHES = 0
    fused_scan.VARIANT_LAUNCHES.clear()
    t0 = time.perf_counter()
    res = engine.query(CONFIG2)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches, variants = fused_scan.LAUNCHES, dict(fused_scan.VARIANT_LAUNCHES)
    if sorted(res.rows) != want:
        raise AssertionError(f"realtime {label}: config 2 differs from the numpy golden")
    if launches != expect_launches:
        raise AssertionError(f"realtime {label}: {launches} fused-scan launches, expected {expect_launches}")
    return {"launches": launches, "instantiations": variants, "first_wall_ms": wall_ms, "groups": len(res.rows)}


def _snapshot_bytes(snap) -> int:
    return sum(t.numel() * t.element_size() for entries in snap._device_cache.values()
               for entry in entries.values() for t in entry.values())


class _SealClock:
    """Times each RealtimeSegmentDataManager.seal_and_swap (the build, the
    save, the swap and the checkpoint) while installed."""

    def __init__(self):
        from pinot_tpu_torch.realtime import manager

        self.cls, self.orig, self.seconds = manager.RealtimeSegmentDataManager, None, []

    def __enter__(self):
        self.orig = orig = self.cls.seal_and_swap
        clock = self

        def timed(mgr):
            t0 = time.perf_counter()
            out = orig(mgr)
            clock.seconds.append(time.perf_counter() - t0)
            return out

        self.cls.seal_and_swap = timed
        return self

    def __exit__(self, *exc):
        self.cls.seal_and_swap = self.orig


def _rt_hybrid(seg, rng, root):
    """(r1): phase 4's 8 offline segments (already on the card) with a
    realtime part of one partition: 2^20 + 2^19 rows through InMemoryStream,
    one sealed 2^20-row segment saved under build/ and a 2^19-row
    consuming snapshot; config 2 exact over all rows, 8 + 1 + 1 launches."""
    from pinot_tpu_torch.query.engine import QueryEngine
    from pinot_tpu_torch.realtime import InMemoryStream, RealtimeTableDataManager

    schema, cfg = _rt_schema(False), _rt_config(False)
    offline = seg["engine"].table("lineorder")
    engine = QueryEngine()  # device None: CUDA, raising without it
    engine.register_table(offline.schema, offline.config)
    for s in offline.segments:
        engine.add_segment("lineorder", s)
    stream = InMemoryStream(1)
    mgr = RealtimeTableDataManager(schema, cfg, os.path.join(root, "hybrid"), stream=stream)
    engine.attach_realtime("lineorder", mgr)
    d = lineorder_segment(rng, RT_R1_MESSAGES)
    t0 = time.perf_counter()
    msgs = _messages(d)
    stream.publish_many(msgs, partition=0)
    publish_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    with _SealClock() as clock:
        t1 = time.perf_counter()
        n = mgr.consume_all()
        consume_s = time.perf_counter() - t1
    t2 = time.perf_counter()
    snap = mgr.managers[0].mutable.snapshot()
    snapshot_ms = (time.perf_counter() - t2) * 1e3
    if n != RT_R1_MESSAGES or len(mgr.sealed[0]) != 1 or snap.num_docs != RT_R1_MESSAGES - RT_SEGMENT_ROWS:
        raise AssertionError(f"realtime r1: {n} rows, {len(mgr.sealed[0])} sealed, snapshot {snap.num_docs}")
    if not os.path.isdir(mgr.segment_dir(mgr.sealed[0][0].name)):
        raise AssertionError("realtime r1: the sealed segment is not on disk")
    off_sum = np.zeros(2406)
    off_cnt = np.zeros(2406, np.int64)
    for day, s, c in seg["golden"]["a_config2"]:
        off_sum[day - 19920101], off_cnt[day - 19920101] = s, c
    rt_sum, rt_cnt = _config2_tables(d)
    sums, cnts = off_sum + rt_sum, off_cnt + rt_cnt
    check = _rt_counted(engine, _config2_rows(sums, cnts), "r1", len(offline.segments) + 2)
    rec = {"rows": {"offline": sum(s.num_docs for s in offline.segments), "sealed": RT_SEGMENT_ROWS,
                    "consuming": snap.num_docs},
           "publish_rows_per_s": RT_R1_MESSAGES / publish_s, "ingest_rows_per_s": n / consume_s,
           "consume_s": consume_s, "seal_s": clock.seconds, "snapshot_ms": snapshot_ms,
           "peak_allocated_bytes": torch.cuda.max_memory_allocated(), **check}
    rec.update(_wall_ms(engine, CONFIG2))
    return {"engine": engine, "mgr": mgr, "stream": stream, "sums": sums, "cnts": cnts, "record": rec}


def _rt_freshness(r1, rng):
    """(r2): 20 cycles of publish 4096 rows -> consume -> config 2, each
    answer exact with the new rows; the allocation after cycle 20 at most
    one snapshot's device bytes + 64 MiB above the one after cycle 1."""
    from pinot_tpu_torch.ops import fused_scan

    engine, mgr, stream = r1["engine"], r1["mgr"], r1["stream"]
    sums, cnts = r1["sums"].copy(), r1["cnts"].copy()
    cycles, allocated = [], []
    torch.cuda.reset_peak_memory_stats()
    fused_scan.LAUNCHES = 0
    fused_scan.VARIANT_LAUNCHES.clear()
    for i in range(RT_FRESH_CYCLES):
        d = lineorder_segment(rng, RT_FRESH_ROWS)
        msgs = _messages(d)
        t0 = time.perf_counter()
        stream.publish_many(msgs, partition=0)
        n = mgr.consume_all()
        t1 = time.perf_counter()
        snap = mgr.managers[0].mutable.snapshot()
        t2 = time.perf_counter()
        res = engine.query(CONFIG2)
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        s, c = _config2_tables(d)
        sums, cnts = sums + s, cnts + c
        if n != RT_FRESH_ROWS or sorted(res.rows) != _config2_rows(sums, cnts):
            raise AssertionError(f"realtime r2: cycle {i} is not exact with its {RT_FRESH_ROWS} new rows")
        allocated.append(torch.cuda.memory_allocated())
        cycles.append({"publish_to_visible_ms": (t3 - t0) * 1e3, "consume_ms": (t1 - t0) * 1e3,
                       "snapshot_ms": (t2 - t1) * 1e3, "wall_ms": (t3 - t2) * 1e3, "snapshot_rows": snap.num_docs,
                       "allocated_bytes": allocated[-1]})
    snap_bytes = _snapshot_bytes(mgr.managers[0].mutable.snapshot())
    growth = allocated[-1] - allocated[0]
    if growth > snap_bytes + RT_MEMORY_SLACK:
        raise AssertionError(f"realtime r2: device allocation grew {growth} B over {RT_FRESH_CYCLES} cycles "
                             f"(limit {snap_bytes} + {RT_MEMORY_SLACK})")
    launches = fused_scan.LAUNCHES
    if launches != RT_FRESH_CYCLES * (len(engine.table("lineorder").segments) + 2):
        raise AssertionError(f"realtime r2: {launches} fused-scan launches")
    walls = [c["wall_ms"] for c in cycles]
    return {"cycles": cycles, "launches": launches, "instantiations": dict(fused_scan.VARIANT_LAUNCHES),
            "publish_to_visible_ms_median": statistics.median(c["publish_to_visible_ms"] for c in cycles),
            "snapshot_ms_median": statistics.median(c["snapshot_ms"] for c in cycles),
            "median_ms": statistics.median(walls), "snapshot_device_bytes": snap_bytes,
            "allocated_growth_bytes": growth, "allocated_gate_bytes": snap_bytes + RT_MEMORY_SLACK,
            "ingest_rows_per_s": RT_FRESH_ROWS / statistics.median(c["consume_ms"] / 1e3 for c in cycles),
            "peak_allocated_bytes": torch.cuda.max_memory_allocated()}


def _upsert_data(rng):
    """(r3)'s messages: lineorder rows with lo_orderkey uniform over 2^20
    keys and ts strictly increasing; and the latest row of each key."""
    d = lineorder_segment(rng, RT_UPSERT_MESSAGES)
    d["lo_orderkey"] = rng.integers(0, RT_UPSERT_KEYS, RT_UPSERT_MESSAGES).astype(np.int64)
    d["ts"] = 1_700_000_000_000 + np.arange(RT_UPSERT_MESSAGES, dtype=np.int64)
    _, last_rev = np.unique(d["lo_orderkey"][::-1], return_index=True)
    latest = RT_UPSERT_MESSAGES - 1 - last_rev
    return d, {k: v[latest] for k, v in d.items()}


def _upsert_engine(mgr):
    from pinot_tpu_torch.query.engine import QueryEngine

    engine = QueryEngine()
    engine.register_table(_rt_schema(True), _rt_config(True))
    engine.attach_realtime("lineorder", mgr)
    return engine


def _valid_params(engine, mgr):
    """Every realtime segment's config 2 plan ships the validDocIds mask."""
    from pinot_tpu_torch.query import planner
    from pinot_tpu_torch.sql.parser import parse_query

    segs = mgr.query_segments()
    masked = [("__valid__" in planner.plan_segment(parse_query(CONFIG2), s, engine.device).params) for s in segs]
    if not all(masked) or any(s.valid_docs is None for s in segs):
        raise AssertionError(f"realtime: not every upsert segment carries its validDocIds: {masked}")
    return {"segments": len(segs), "valid_rows": int(sum(int(np.count_nonzero(s.valid_docs)) for s in segs)),
            "rows": int(sum(s.num_docs for s in segs))}


def _rt_upsert(rng, root):
    """(r3): FULL upsert over 2 partitions by partition_of(lo_orderkey):
    each seals one 2^20-row segment and keeps a consuming snapshot; config
    2 exact against the latest row per key, launches carrying the mask."""
    from pinot_tpu_torch.realtime import InMemoryStream, RealtimeTableDataManager
    from pinot_tpu_torch.utils.hashing import partition_of

    d, latest = _upsert_data(rng)
    t0 = time.perf_counter()
    msgs = _messages(d)
    keys = np.unique(d["lo_orderkey"]).tolist()
    part = dict(zip(keys, (partition_of(k, RT_UPSERT_PARTITIONS) for k in keys)))
    stream = InMemoryStream(RT_UPSERT_PARTITIONS)
    for m in msgs:
        k = m["lo_orderkey"]
        stream.publish(m, key=k, partition=part[k])
    publish_s = time.perf_counter() - t0
    data_dir = os.path.join(root, "upsert")
    mgr = RealtimeTableDataManager(_rt_schema(True), _rt_config(True), data_dir, stream=stream)
    engine = _upsert_engine(mgr)
    torch.cuda.reset_peak_memory_stats()
    with _SealClock() as clock:
        t1 = time.perf_counter()
        n = mgr.consume_all()
        consume_s = time.perf_counter() - t1
    t2 = time.perf_counter()
    snaps = [m.mutable.snapshot() for m in mgr.managers.values()]
    snapshot_ms = (time.perf_counter() - t2) * 1e3
    sealed = [len(mgr.sealed[p]) for p in range(RT_UPSERT_PARTITIONS)]
    if n != RT_UPSERT_MESSAGES or sealed != [1] * RT_UPSERT_PARTITIONS:
        raise AssertionError(f"realtime r3: {n} rows consumed, sealed {sealed}")
    want = _config2_rows(*_config2_tables(latest))
    masks = _valid_params(engine, mgr)
    if masks["valid_rows"] != len(latest["lo_orderkey"]):
        raise AssertionError(f"realtime r3: {masks['valid_rows']} valid rows, {len(latest['lo_orderkey'])} keys")
    check = _rt_counted(engine, want, "r3", 2 * RT_UPSERT_PARTITIONS)
    rec = {"messages": RT_UPSERT_MESSAGES, "keys": len(latest["lo_orderkey"]), "partitions": RT_UPSERT_PARTITIONS,
           "consuming_rows": [s.num_docs for s in snaps], "masks": masks,
           "publish_rows_per_s": RT_UPSERT_MESSAGES / publish_s, "ingest_rows_per_s": n / consume_s,
           "consume_s": consume_s, "seal_s": clock.seconds, "snapshot_ms": snapshot_ms,
           "peak_allocated_bytes": torch.cuda.max_memory_allocated(), **check}
    rec.update(_wall_ms(engine, CONFIG2))
    return {"engine": engine, "mgr": mgr, "stream": stream, "data_dir": data_dir, "want": want,
            "latest": latest, "record": rec}


def _rt_restart(r3):
    """(r4): a fresh manager over (r3)'s data directory: the sealed segments
    loaded with verify, the upsert bootstrap, the tail re-consumed past
    the checkpoint; the same answer."""
    from pinot_tpu_torch.realtime import RealtimeTableDataManager

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mgr = RealtimeTableDataManager(_rt_schema(True), _rt_config(True), r3["data_dir"], stream=r3["stream"])
    recover_s = time.perf_counter() - t0
    t1 = time.perf_counter()
    n = mgr.consume_all()
    reconsume_s = time.perf_counter() - t1
    want_tail = sum(m.mutable.num_docs for m in r3["mgr"].managers.values())
    recovered = [len(mgr.sealed[p]) for p in range(RT_UPSERT_PARTITIONS)]
    if n != want_tail or recovered != [1] * RT_UPSERT_PARTITIONS:
        raise AssertionError(f"realtime r4: recovered {recovered} sealed, re-consumed {n} rows of {want_tail}")
    engine = _upsert_engine(mgr)
    masks = _valid_params(engine, mgr)
    check = _rt_counted(engine, r3["want"], "r4", 2 * RT_UPSERT_PARTITIONS)
    rec = {"recovery_s": recover_s + reconsume_s, "load_and_bootstrap_s": recover_s, "reconsume_s": reconsume_s,
           "reconsumed_rows": n, "ingest_rows_per_s": n / reconsume_s, "masks": masks,
           "peak_allocated_bytes": torch.cuda.max_memory_allocated(), **check}
    rec.update(_wall_ms(engine, CONFIG2))
    return {"engine": engine, "mgr": mgr, "record": rec}


def _rt_distributed(r3, r4):
    """(r5): StackedTable.from_segments over (r4)'s query segments (the
    rows outside validDocIds dropped) into DistributedEngine() on CUDA;
    config 2 exact against the same golden in one launch."""
    from pinot_tpu_torch.parallel.engine import DistributedEngine
    from pinot_tpu_torch.parallel.stacked import StackedTable

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    stacked = StackedTable.from_segments(r4["mgr"].query_segments(), num_shards=1, table_config=_rt_config(True))
    stack_s = time.perf_counter() - t0
    if stacked.num_docs != len(r3["latest"]["lo_orderkey"]):
        raise AssertionError(f"realtime r5: {stacked.num_docs} stacked rows after compaction")
    engine = DistributedEngine()
    engine.register_table("lineorder", stacked)
    check = _rt_counted(engine, r3["want"], "r5", 1)
    rec = {"stacked_rows": stacked.num_docs, "stack_s": stack_s,
           "peak_allocated_bytes": torch.cuda.max_memory_allocated(), **check}
    rec.update(_wall_ms(engine, CONFIG2))
    return {"engine": engine, "stacked": stacked, "record": rec}


def phase_realtime_path(seg, seed):
    """Phase 4i: (r1)-(r5).  Returns the launches of the counted runs, the
    records, the profiles and what the script cleans up at its end."""
    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="realtime_", dir=os.path.join(REPO, "build"))
    r1 = _rt_hybrid(seg, rng, root)
    log("realtime_check", item="r1_hybrid", exact=True, **{k: r1["record"][k] for k in ("launches", "rows")})
    r2 = _rt_freshness(r1, rng)
    log("realtime_check", item="r2_freshness", exact=True, launches=r2["launches"],
        allocated_growth_bytes=r2["allocated_growth_bytes"], allocated_gate_bytes=r2["allocated_gate_bytes"])
    r3 = _rt_upsert(rng, root)
    log("realtime_check", item="r3_upsert", exact=True, launches=r3["record"]["launches"], masks=r3["record"]["masks"])
    r4 = _rt_restart(r3)
    log("realtime_check", item="r4_restart", exact=True, launches=r4["record"]["launches"],
        recovery_s=r4["record"]["recovery_s"])
    r5 = _rt_distributed(r3, r4)
    log("realtime_check", item="r5_distributed", exact=True, launches=r5["record"]["launches"])
    records = {"r1_hybrid": r1["record"], "r2_freshness": r2, "r3_upsert": r3["record"],
               "r4_restart": r4["record"], "r5_distributed": r5["record"]}
    engines = {"r1_hybrid": r1["engine"], "r2_freshness": r1["engine"], "r3_upsert": r3["engine"],
               "r4_restart": r4["engine"], "r5_distributed": r5["engine"]}
    launches = sum(r["launches"] for r in records.values())
    variants = {}
    for r in records.values():
        for k, v in r["instantiations"].items():
            variants[k] = variants.get(k, 0) + v
    # one profile per engine: r2's engine is r1's, over the grown snapshot
    profiles = [("realtime_profile", {"engine": name, "query": "config2"}, e, CONFIG2)
                for name, e in engines.items() if name != "r2_freshness"]
    return {"launches": launches, "variants": variants, "records": records, "profiles": profiles,
            "root": root, "dist_engine": r5["engine"], "realtime_s": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# phase 4d: storage — segment persistence on the segment engine, the
# residency sweep on the distributed engine, on the tables phases 4 and 4b
# built
# ---------------------------------------------------------------------------
REPO = os.path.dirname(os.path.abspath(__file__))
STORAGE_QUERIES = {"a_config2": CONFIG2, "b_filtered_agg": QUERY_B, "c_two_dim_groupby": QUERY_C,
                   "e_filter_groupby": TRANSFORM_QUERIES["e_filter_groupby"]}
# a nullable INT column added to the table schema after the segments were built
EVOLVED_QUERIES = {
    "added_count_sum": "SELECT COUNT(lo_added), SUM(lo_added), COUNT(*) FROM lineorder",
    "added_is_null": "SELECT COUNT(*) FROM lineorder WHERE lo_added IS NULL",
}
# the residency sweep (bench.py _working_set_sweep at phase 4b's table):
# about 16 launches, and each leg's cache budget from the working set W
SWEEP_LAUNCHES = 16
SWEEP_QUERIES = ("a_bench", "c_min_max_groupby")
SWEEP_LEGS = (("0.5x", lambda w: 2 * w), ("1x", lambda w: w + (64 << 10)), ("4x", lambda w: w // 4))
RACING_RUNS = 6
RACING_PERIOD_S = 0.002


def _rows_exact(name: str, rows, want) -> bool:
    return (sorted(rows) if name in ("a_config2", "a_bench", "e_filter_groupby") else list(rows)) == want


def _counters():
    from pinot_tpu_torch.ops import fused_scan

    return fused_scan.LAUNCHES, fused_scan.MASK_WORDS_LAUNCHES, dict(fused_scan.VARIANT_LAUNCHES)


def _zero_counters():
    from pinot_tpu_torch.ops import fused_scan

    fused_scan.LAUNCHES = fused_scan.MASK_WORDS_LAUNCHES = 0
    fused_scan.VARIANT_LAUNCHES.clear()


def _storage_persistence(seg, transform):
    """save the segment engine's 8 segments, load each verified into a fresh
    QueryEngine() under the table schema plus one added nullable column, and
    run (a), (b), (c), (e) and the added column's queries, exact."""
    from pinot_tpu_torch.query.engine import QueryEngine
    from pinot_tpu_torch.segment.segment import ImmutableSegment
    from pinot_tpu_torch.spi.schema import DataType, FieldRole, FieldSpec, Schema

    mem = seg["engine"]
    state = mem.tables["lineorder"]
    golden = dict(seg["golden"], e_filter_groupby=transform["seg_golden"]["e_filter_groupby"])
    total = sum(s.num_docs for s in state.segments)
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="storage_segments_", dir=os.path.join(REPO, "build"))
    try:
        t0 = time.perf_counter()
        paths = []
        for s in state.segments:
            paths.append(os.path.join(root, s.name))
            s.save(paths[-1])
        write_s = time.perf_counter() - t0
        disk_bytes = sum(os.path.getsize(os.path.join(p, f)) for p in paths for f in os.listdir(p))
        evolved = Schema("lineorder", list(state.schema.fields) + [
            FieldSpec("lo_added", DataType.INT, role=FieldRole.METRIC, nullable=True)])
        loaded = QueryEngine()  # device None: CUDA, raising without it
        loaded.register_table(evolved, state.config)
        t1 = time.perf_counter()
        for p in paths:
            loaded.add_segment("lineorder", ImmutableSegment.load(p, verify=True))
        load_s = time.perf_counter() - t1

        # the counted run: counts set to 0 just before, read just after; each
        # query's first run copies its columns from the mmaps
        _zero_counters()
        rows, first_ms, per = {}, {}, {}
        for name, sql in STORAGE_QUERIES.items():
            before = _counters()
            t = time.perf_counter()
            rows[name] = loaded.query(sql).rows
            torch.cuda.synchronize()
            first_ms[name] = (time.perf_counter() - t) * 1e3
            after = _counters()
            per[name] = {"launches": after[0] - before[0],
                         "instantiations": {k: v - before[2].get(k, 0) for k, v in after[2].items()
                                            if v != before[2].get(k, 0)}}
        launches, variants = _counters()[0], _counters()[2]
        evolved_rows = {name: loaded.query(sql).rows for name, sql in EVOLVED_QUERIES.items()}
        for name, want in golden.items():
            if not _rows_exact(name, rows[name], want):
                raise AssertionError(f"loaded-segment query {name} differs from the numpy golden")
            if sorted(rows[name]) != sorted(mem.query(STORAGE_QUERIES[name]).rows):
                raise AssertionError(f"loaded-segment query {name} differs from the in-memory engine")
        n_seg = len(paths)
        if per["a_config2"] != {"launches": n_seg, "instantiations": {"p16/i32/shared": n_seg}}:
            raise AssertionError(f"loaded query (a) did not launch the fused scan once a segment: {per['a_config2']}")
        want_evolved = {"added_count_sum": [(0, None, total)], "added_is_null": [(total,)]}
        if evolved_rows != want_evolved:
            raise AssertionError(f"schema evolution: {evolved_rows} vs {want_evolved}")
        warm = {name: _wall_ms(loaded, sql) for name, sql in STORAGE_QUERIES.items()}
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for s in loaded.tables["lineorder"].segments:
        s.release_device()
    return {"segments": n_seg, "rows": total, "disk_bytes": disk_bytes, "write_s": write_s,
            "verify_and_load_s": load_s, "first_query_ms": first_ms, "warm": warm, "launches": launches,
            "instantiations": variants, "per_query": per, "schema_evolution": evolved_rows}


def _trace_streams(engine, sql: str) -> dict:
    """One profiled run: the streams of the host-to-device copies and of the
    fused scan, pinned vs pageable copies, and the device's busy time as
    the union of its events over the wall (copies and kernels overlap on
    two streams, so a sum would double-count)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.query(sql)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    path = os.path.join(REPO, "build", "storage_trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = [e for e in json.load(f).get("traceEvents", [])
                  if e.get("ph") == "X" and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    os.remove(path)

    def union(spans):
        out = []
        for a, b in sorted(spans):
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def length(spans):
        return sum(b - a for a, b in spans)

    def stream(e):
        return (e.get("args") or {}).get("stream", e.get("tid"))

    htod = [e for e in events if e["cat"] == "gpu_memcpy" and "HtoD" in e["name"]]
    scans = [e for e in events if e["cat"] == "kernel" and "fused_scan" in e["name"]]
    kernels = union([(e["ts"], e["ts"] + e["dur"]) for e in events if e["cat"] == "kernel"])
    copies = union([(e["ts"], e["ts"] + e["dur"]) for e in htod])
    # the copies' time that a kernel covers (both unions are sorted, disjoint)
    both, i, j = 0.0, 0, 0
    while i < len(copies) and j < len(kernels):
        both += max(0.0, min(copies[i][1], kernels[j][1]) - max(copies[i][0], kernels[j][0]))
        if copies[i][1] < kernels[j][1]:
            i += 1
        else:
            j += 1
    busy_ms = length(union([(e["ts"], e["ts"] + e["dur"]) for e in events])) / 1e3
    htod_streams = sorted({stream(e) for e in htod}, key=str)
    scan_streams = sorted({stream(e) for e in scans}, key=str)
    return {
        "profiled_wall_ms": wall_ms,
        "device_events": len(events),
        "htod_copies": len(htod),
        "htod_pinned": sum("Pinned" in e["name"] for e in htod),
        "htod_pageable": sum("Pageable" in e["name"] for e in htod),
        "htod_ms": length(copies) / 1e3,
        "htod_streams": htod_streams,
        "scan_launches_captured": len(scans),
        "scan_streams": scan_streams,
        "copies_on_another_stream": bool(htod_streams) and not set(htod_streams) & set(scan_streams),
        "copy_ms_overlapped_by_kernels": both / 1e3,
        "device_busy_ms": busy_ms if events else "not measured",
        "device_idle_share": 1.0 - busy_ms / wall_ms if events else "not measured",
    }


def _sweep_leg(label, eng, stacked, sqls, want, ref_rows, n):
    """One budget: a cold pass, the counted run of (a) (launches with
    mask_words), warm medians of 5 with the staging counters around them,
    and the peak allocated bytes over the leg's starting allocation."""
    from pinot_tpu_torch.sql.parser import parse_query
    from pinot_tpu_torch.utils.metrics import METRICS

    nb = len(eng._plan(parse_query(sqls["a_bench"]), stacked).batch_offsets)
    evictions = METRICS.counter("residency.evictions")  # every engine's manager is named "residency"
    ev0 = evictions.value
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    for name, sql in sqls.items():  # cold: stages every slice once
        if not _rows_exact(name, eng.query(sql).rows, want[name]):
            raise AssertionError(f"{label} leg: cold {name} differs from the numpy golden")
    _zero_counters()
    res = eng.query(sqls["a_bench"])
    torch.cuda.synchronize()
    launches, mask_words, variants = _counters()
    if not _rows_exact("a_bench", res.rows, want["a_bench"]) or launches != nb or mask_words != nb:
        raise AssertionError(f"{label} leg: (a) launched {launches} ({mask_words} with mask_words), want {nb}")
    h0 = METRICS.counter("engine.prefetchHits").value
    s0 = METRICS.counter("engine.stagingStalls").value
    st0 = METRICS.histogram("residency.stagingStallMs")._snap()
    ev_warm0 = evictions.value
    timings = {}
    for name, sql in sqls.items():
        ms = []
        for _ in range(5):
            t0 = time.perf_counter()
            rows = eng.query(sql).rows
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            if rows != ref_rows[name]:
                raise AssertionError(f"{label} leg: {name} differs from the untiered engine")
        med = statistics.median(ms)
        timings[name] = {"median_ms": med, "rows_per_s": n / (med / 1e3), "runs_ms": ms}
    hits = METRICS.counter("engine.prefetchHits").value - h0
    stalls = METRICS.counter("engine.stagingStalls").value - s0
    st1 = METRICS.histogram("residency.stagingStallMs")._snap()
    snap = eng.residency.snapshot()
    return {
        "budget_bytes": eng.residency.budget.budget_bytes,
        "batches": nb,
        "scan_launches_a": launches,
        "mask_words_launches_a": mask_words,
        "instantiations_a": variants,
        "warm": timings,
        "prefetch_hits": hits,
        "staging_stalls": stalls,
        "prefetch_hit_rate": hits / (hits + stalls) if hits + stalls else "no streamed batch",
        "staging_stall_ms": st1["count"] * st1["meanMs"] - st0["count"] * st0["meanMs"],
        "evictions_in_leg": evictions.value - ev0,
        "evictions_in_warm_runs": evictions.value - ev_warm0,
        "resident_bytes": snap["residentBytes"],
        "budget_peak_bytes": eng.residency.budget.peak,
        "allocated_at_start": base,
        "peak_allocated_over_start": torch.cuda.max_memory_allocated() - base,
        "exact": True,
    }


def _racing_evictor(eng, sql: str, want_rows) -> dict:
    """RACING_RUNS runs of `sql` while a thread evicts every resident group
    every RACING_PERIOD_S: every run exact."""
    stop = threading.Event()
    evicted = [0]

    def evictor():
        while not stop.is_set():
            evicted[0] += eng.residency.evict_matching(lambda g: True)
            time.sleep(RACING_PERIOD_S)

    th = threading.Thread(target=evictor, daemon=True)
    th.start()
    try:
        exact = [eng.query(sql).rows == want_rows for _ in range(RACING_RUNS)]
        torch.cuda.synchronize()
    finally:
        stop.set()
        th.join(timeout=30)
    if not all(exact) or th.is_alive():
        raise AssertionError(f"racing evictor: exact {exact}, evictor alive {th.is_alive()}")
    return {"runs": RACING_RUNS, "exact": True, "groups_evicted": evicted[0]}


def _drop_slices(eng, plan_sqls, stacked, dev):
    """Remove an engine's doc slices from the table's device cache (the
    table's cache is shared by every engine on the device)."""
    from pinot_tpu_torch.sql.parser import parse_query

    for sql in plan_sqls:
        plan = eng._plan(parse_query(sql), stacked)
        for off, _ in plan.batch_offsets:
            stacked.evict_slice(dev, (off, off + plan.batch_docs))


def _storage_sweep(dist, dev):
    """Phase 4b's table at about 16 launches: W of (a) and (c) with an
    unbounded budget, then legs at 0.5x, 1x and 4x (budget 2W, W + 64 KiB,
    W / 4), each exact against the golden and the untiered engine; the 4x
    leg profiled once and raced by an evictor."""
    from pinot_tpu_torch.parallel.engine import DistributedEngine

    stacked = dist["stacked"]
    n = stacked.num_docs
    sqls = {name: DIST_QUERIES[name] for name in SWEEP_QUERIES}
    want = {name: dist["golden"][name] for name in SWEEP_QUERIES}
    bytes_per_doc = sum(
        (c.code_bits / 8.0 if c.code_bits and c.packed is not None else c.codes.dtype.itemsize)
        if c.codes is not None else c.values.dtype.itemsize
        for c in stacked.columns.values())
    table_bytes = int(bytes_per_doc * stacked.num_shards * stacked.docs_per_shard)
    launch_bytes = table_bytes // SWEEP_LAUNCHES + 1

    untiered = DistributedEngine(launch_bytes=launch_bytes, hbm_cache_bytes=0)
    untiered.register_table("lineorder", stacked)
    ref_rows = {name: untiered.query(sql).rows for name, sql in sqls.items()}
    for name in sqls:
        if not _rows_exact(name, ref_rows[name], want[name]):
            raise AssertionError(f"untiered sweep engine: {name} differs from the numpy golden")
    _drop_slices(untiered, sqls.values(), stacked, dev)

    probe = DistributedEngine(launch_bytes=launch_bytes, hbm_cache_bytes=1 << 40)
    probe.register_table("lineorder", stacked)
    for name, sql in sqls.items():
        if probe.query(sql).rows != ref_rows[name]:
            raise AssertionError(f"unbounded tiered probe: {name} differs from the untiered engine")
    w = int(probe.residency.resident_bytes)
    probe.residency.evict_matching(lambda g: True)
    probe.residency.shutdown()
    log("storage_sweep_setup", rows=n, table_bytes=table_bytes, launch_bytes=launch_bytes, working_set_bytes=w,
        cut=("table 2^27 rows (about SSB SF22, ~1 GB on the card) and budgets scaled with it: the ratio of "
             "working set to budget is what the sweep measures; a table larger than the card needs more "
             "host RAM and build time than the run has"))

    legs, launches, variants, extra = {}, 0, {}, {}
    for label, budget_of in SWEEP_LEGS:
        eng = DistributedEngine(launch_bytes=launch_bytes, hbm_cache_bytes=budget_of(w))
        eng.register_table("lineorder", stacked)
        try:
            legs[label] = _sweep_leg(label, eng, stacked, sqls, want, ref_rows, n)
            launches += legs[label]["scan_launches_a"]
            for k, v in legs[label]["instantiations_a"].items():
                variants[k] = variants.get(k, 0) + v
            log("storage_leg", leg=label, working_set_bytes=w, **legs[label])
            if label == "4x":
                extra["profile_4x_a"] = _trace_streams(eng, sqls["a_bench"])
                log("storage_profile", leg=label, query="a_bench", **extra["profile_4x_a"])
                extra["racing_4x_c"] = _racing_evictor(eng, sqls["c_min_max_groupby"], ref_rows["c_min_max_groupby"])
                log("storage_racing_evictor", leg=label, query="c_min_max_groupby", **extra["racing_4x_c"])
        finally:
            eng.residency.evict_matching(lambda g: True)
            eng.residency.shutdown()
    four = legs["4x"]
    if four["evictions_in_warm_runs"] <= 0:
        raise AssertionError(f"4x leg: no eviction in the warm runs: {four}")
    for label, leg in legs.items():  # every streamed batch consumed once: a hit or a stall
        if leg["prefetch_hits"] + leg["staging_stalls"] != 5 * len(sqls) * leg["batches"]:
            raise AssertionError(f"{label} leg: {leg['prefetch_hits']} hits + {leg['staging_stalls']} stalls "
                                 f"for {5 * len(sqls)} queries of {leg['batches']} batches")
    prof = extra["profile_4x_a"]
    if prof["htod_copies"] and not (prof["copies_on_another_stream"] and prof["htod_pageable"] == 0):
        raise AssertionError(f"4x leg: the staging copies did not run pinned on a stream of their own: {prof}")
    return {"working_set_bytes": w, "launch_bytes": launch_bytes, "legs": legs, "launches": launches,
            "variants": variants, **extra}


def _residency_walls(dist) -> dict:
    """Phase 4b's engines (default residency, 8 GiB: the table fits) against
    untiered engines at the same launch budgets, in turns (tiered,
    untiered, untiered, tiered; 3 runs a turn): the cost of the staging
    path when every slice is resident."""
    from pinot_tpu_torch.parallel.engine import DistributedEngine

    out = {}
    for label, e in dist["engines"].items():
        flat = DistributedEngine(launch_bytes=e.launch_bytes, hbm_cache_bytes=0)
        flat.register_table("lineorder", dist["stacked"])
        for name in ("a_bench", "b_filtered_agg", "c_min_max_groupby"):
            sql = DIST_QUERIES[name]
            if flat.query(sql).rows != e.query(sql).rows:
                raise AssertionError(f"{label} {name}: the untiered engine differs from the tiered one")
            ms = {"tiered": [], "untiered": []}
            for turn in ("tiered", "untiered", "untiered", "tiered"):
                eng = e if turn == "tiered" else flat
                ms[turn].extend(_wall_ms(eng, sql, runs=3)["runs_ms"])
            out[f"{label}/{name}"] = {k: {"median_ms": statistics.median(v), "runs_ms": v} for k, v in ms.items()}
    return out


def _copy_rates(dev, nbytes: int = 512 << 20, chunk: int = 64 << 20) -> dict:
    """GB/s of the staging path's pieces on this machine, medians of 3 over
    `nbytes` in `chunk` pieces: a host copy into a pinned buffer by numpy
    (one thread) and by torch (intra-op threads), and a copy to the card
    from the pinned buffer and from pageable memory."""
    src = np.random.default_rng(0).integers(0, 255, nbytes, dtype=np.uint8)
    src_t = torch.from_numpy(src)
    pinned = torch.empty(chunk, dtype=torch.uint8, pin_memory=True)
    pinned_np = pinned.numpy()
    dst = torch.empty(chunk, dtype=torch.uint8, device=dev)
    steps = {
        "host_to_pinned_numpy": lambda off: pinned_np.__setitem__(slice(None), src[off: off + chunk]),
        "host_to_pinned_torch": lambda off: pinned.copy_(src_t[off: off + chunk]),
        "pinned_to_device": lambda off: dst.copy_(pinned, non_blocking=True),
        "pageable_to_device": lambda off: dst.copy_(src_t[off: off + chunk]),
    }
    out = {}
    for name, step in steps.items():
        ts = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for off in range(0, nbytes, chunk):
                step(off)
            torch.cuda.synchronize()
            ts.append(time.perf_counter() - t0)
        out[name] = nbytes / statistics.median(ts) / 1e9
    return out


# ---------------------------------------------------------------------------
# phase 4j: cross-query batching on the server and the distributed engine
# ---------------------------------------------------------------------------
def _batch_q(k: int) -> str:
    """BASELINE config 2 with the lo_quantity bound as the member's literal."""
    return CONFIG2.replace("lo_quantity < 25", f"lo_quantity < {k}")


def _batch_disc_q(k: int) -> str:
    return ("SELECT lo_orderdate, SUM(lo_revenue), COUNT(*) FROM lineorder "
            f"WHERE lo_discount BETWEEN {k} AND {k + 2} GROUP BY lo_orderdate LIMIT 2500")


def _od_tables(datas, col: str, width: int):
    """COUNT(*) and SUM(lo_revenue) by (day, value of `col`), [2406, width]
    (the revenue sums exact in f64: below 2^53)."""
    cnt = np.zeros(2406 * width, np.int64)
    rev = np.zeros(2406 * width, np.float64)
    for d in datas:
        key = (d["lo_orderdate"] - 19920101).astype(np.int64) * width + d[col]
        cnt += np.bincount(key, minlength=2406 * width)
        rev += np.bincount(key, weights=d["lo_revenue"], minlength=2406 * width)
    return cnt.reshape(2406, width), rev.reshape(2406, width)


def _od_rows(cnt, rev, lo: int, hi: int):
    """The golden rows of a group-by of days over values [lo, hi) of the
    table's second axis."""
    c, r = cnt[:, lo:hi].sum(axis=1), rev[:, lo:hi].sum(axis=1)
    return sorted((19920101 + int(i), float(r[i]), int(c[i])) for i in np.nonzero(c)[0])


class _Call:
    """A zero-argument call under the profiler's query interface."""

    def __init__(self, fn):
        self.fn = fn

    def query(self, _sql):
        return self.fn()


def _scan_counts():
    from pinot_tpu_torch.ops import fused_scan

    return (fused_scan.LAUNCHES, dict(fused_scan.VARIANT_LAUNCHES), dict(fused_scan.BATCH_LAUNCHES),
            fused_scan.BATCH_MEMBERS, dict(fused_scan.BATCH_LAYOUTS))


def _scan_delta(before):
    """Launches, launches by instantiation, member-axis launches by
    instantiation, members, and member-axis launches by "W/Wg" (members,
    members a block) since `before` (a _scan_counts())."""
    from pinot_tpu_torch.ops import fused_scan

    def diff(now, then):
        return {k: v - then.get(k, 0) for k, v in now.items() if v != then.get(k, 0)}

    return {"launches": fused_scan.LAUNCHES - before[0],
            "instantiations": diff(fused_scan.VARIANT_LAUNCHES, before[1]),
            "member_axis_launches": diff(fused_scan.BATCH_LAUNCHES, before[2]),
            "members": fused_scan.BATCH_MEMBERS - before[3],
            "layouts": diff(fused_scan.BATCH_LAYOUTS, before[4])}


def phase_batch_path(seg, dist):
    """Phase 4j: (q1)-(q6), each counted run exact against numpy; returns the
    counted runs' launches, the records and the profiles."""
    from pinot_tpu_torch.analysis.plan_check import PlanCheckError
    from pinot_tpu_torch.cluster import ServerInstance
    from pinot_tpu_torch.ops import fused_scan
    from pinot_tpu_torch.parallel.engine import DistributedEngine
    from pinot_tpu_torch.query.reduce import reduce_results
    from pinot_tpu_torch.query.safety import Deadline, QueryTimeoutError
    from pinot_tpu_torch.sql.parser import parse_query
    from pinot_tpu_torch.utils.cache import named_cache_stats
    from pinot_tpu_torch.utils.metrics import METRICS

    t0 = time.perf_counter()
    fused_scan.reset_counters()
    counted = []  # the counted runs' _scan_delta records
    records = {}
    q_cnt, q_rev = _od_tables(seg["datas"], "lo_quantity", 51)

    # (q1) a server on the card over phase 4's 8 segments
    server = ServerInstance("s0")
    for s in seg["engine"].table("lineorder").query_segments():
        server.add_segment("lineorder", s)
    names = server.segment_names("lineorder")

    def execute(sql):
        ctx = parse_query(sql)
        res, st = server.execute(ctx, names)
        return reduce_results(ctx, res, st)

    before = _scan_counts()
    out = execute(CONFIG2)
    torch.cuda.synchronize()
    d = _scan_delta(before)
    counted.append(d)
    if sorted(out.rows) != seg["golden"]["a_config2"] or d["launches"] != len(names):
        raise AssertionError(f"(q1) server config 2: exact {sorted(out.rows) == seg['golden']['a_config2']}, {d}")
    res, st = server.execute(parse_query("SET trace = true; " + CONFIG2), names)
    spans = {c["name"]: c for c in st.trace["children"]}
    if "device_wait" not in spans or "deviceMs" not in spans["device_wait"].get("attrs", {}):
        raise AssertionError(f"(q1) the traced call has no device_wait span with deviceMs: {st.trace}")
    records["q1_server_execute"] = {**d, "exact": True, "wall_ms": _wall_ms(_Call(lambda: execute(CONFIG2)), "")[
        "median_ms"], "traced_device_wait_ms": spans["device_wait"]["ms"],
        "traced_device_ms": spans["device_wait"]["attrs"]["deviceMs"], "stats_device_ms": st.device_ms,
        "spans": [c["name"] for c in st.trace["children"]]}
    log("batch_check", item="q1_server_execute", **records["q1_server_execute"])

    # (q2) the same 8 members as phase 3: one member-axis launch a segment
    ks = list(range(18, 18 + BATCH_W))
    want = {k: _od_rows(q_cnt, q_rev, 1, k) for k in ks}

    def batch(deadlines=None):
        ctxs = [parse_query(_batch_q(k)) for k in ks]
        res, stats, errors, _ = server.execute_batch(ctxs, names, deadlines=deadlines)
        rows = [None if errors[i] else reduce_results(ctxs[i], res[i], stats[i]).rows for i in range(len(ks))]
        return rows, errors

    before = _scan_counts()
    rows, errors = batch()
    torch.cuda.synchronize()
    d_batch = _scan_delta(before)
    before = _scan_counts()
    own = [execute(_batch_q(k)).rows for k in ks]
    torch.cuda.synchronize()
    d_seq = _scan_delta(before)
    counted += [d_batch, d_seq]
    for k, r, o, e in zip(ks, rows, own, errors):
        if e is not None or sorted(r) != want[k] or r != o:
            raise AssertionError(f"(q2) member lo_quantity < {k}: error {e}, exact {sorted(r) == want[k]}, "
                                 f"equal to its own execute {r == o}")
    if (d_batch["launches"], sum(d_batch["member_axis_launches"].values()), d_batch["members"]) != (
            len(names), len(names), BATCH_W * len(names)) or d_seq["launches"] != BATCH_W * len(names):
        raise AssertionError(f"(q2) launches: batch {d_batch}, sequential {d_seq}")
    if d_batch["layouts"] != {f"{BATCH_W}/{BATCH_W}": len(names)}:
        raise AssertionError(f"(q2) member-axis launches are not one group of {BATCH_W}: {d_batch['layouts']}")
    batch_ms = _wall_ms(_Call(batch), "")
    seq_ms = _wall_ms(_Call(lambda: [execute(_batch_q(k)) for k in ks]), "")
    records["q2_server_batch"] = {"batch": d_batch, "sequential": d_seq, "exact": True,
                                  "batch_wall_ms": batch_ms["median_ms"], "batch_runs_ms": batch_ms["runs_ms"],
                                  "sequential_wall_ms": seq_ms["median_ms"], "sequential_runs_ms": seq_ms["runs_ms"]}
    log("batch_check", item="q2_server_batch", **records["q2_server_batch"])

    # (q3) one member's deadline already expired: it detaches, 7 stay exact
    bad = 3
    before = _scan_counts()
    rows, errors = batch([Deadline(0.0) if i == bad else None for i in range(BATCH_W)])
    torch.cuda.synchronize()
    d = _scan_delta(before)
    counted.append(d)
    if not isinstance(errors[bad], QueryTimeoutError):
        raise AssertionError(f"(q3) the expired member did not time out: {errors[bad]!r}")
    for i, k in enumerate(ks):
        if i != bad and (errors[i] is not None or sorted(rows[i]) != want[k]):
            raise AssertionError(f"(q3) sibling lo_quantity < {k} is not exact: {errors[i]!r}")
    if d["layouts"] != {f"{BATCH_W - 1}/{BATCH_W - 1}": len(names)}:
        raise AssertionError(f"(q3) the live members' launches are not one group of {BATCH_W - 1}: {d['layouts']}")
    records["q3_expired_member"] = {**d, "exact_siblings": BATCH_W - 1, "error": type(errors[bad]).__name__}
    log("batch_check", item="q3_expired_member", **records["q3_expired_member"])

    # (q4) the distributed engine at the default launch budget over phase
    # 4b's table: 8 lo_discount members in one batched launch; 8 config-2
    # members (row-sharded range-index words: not eligible) one by one
    engine = DistributedEngine()
    engine.register_table("lineorder", dist["stacked"])
    d_cnt, d_rev = _od_tables([dist["data"]], "lo_discount", 11)
    dq_cnt, dq_rev = _od_tables([dist["data"]], "lo_quantity", 51)
    dks = list(range(BATCH_W))
    fallbacks0, batches0 = METRICS.counter("dist.batchFallbacks").value, METRICS.counter("dist.batches").value
    before = _scan_counts()
    outs = engine.execute_many([parse_query(_batch_disc_q(k)) for k in dks])
    torch.cuda.synchronize()
    d_disc = _scan_delta(before)
    before = _scan_counts()
    outs2 = engine.execute_many([parse_query(_batch_q(k)) for k in ks])
    torch.cuda.synchronize()
    d_cfg2 = _scan_delta(before)
    counted += [d_disc, d_cfg2]
    fallbacks = METRICS.counter("dist.batchFallbacks").value - fallbacks0
    batches = METRICS.counter("dist.batches").value - batches0
    for k, o in zip(dks, outs):
        if sorted(o.rows) != _od_rows(d_cnt, d_rev, k, k + 3):
            raise AssertionError(f"(q4) lo_discount BETWEEN {k} AND {k + 2} is not exact")
    for k, o in zip(ks, outs2):
        if sorted(o.rows) != _od_rows(dq_cnt, dq_rev, 1, k):
            raise AssertionError(f"(q4) config 2 lo_quantity < {k} is not exact")
    if (d_disc["launches"], sum(d_disc["member_axis_launches"].values()), fallbacks, batches) != (1, 1, 0, 1):
        raise AssertionError(f"(q4) lo_discount members: {d_disc}, fallbacks {fallbacks}, batches {batches}")
    if d_disc["layouts"] != {f"{BATCH_W}/{BATCH_W}": 1}:
        raise AssertionError(f"(q4) the member-axis launch is not one group of {BATCH_W}: {d_disc['layouts']}")
    if d_cfg2["launches"] != BATCH_W or d_cfg2["member_axis_launches"]:
        raise AssertionError(f"(q4) config-2 members did not run one by one: {d_cfg2}")
    many_ms = _wall_ms(_Call(lambda: engine.execute_many([parse_query(_batch_disc_q(k)) for k in dks])), "", runs=3)
    one_ms = _wall_ms(_Call(lambda: [engine.query(_batch_disc_q(k)) for k in dks]), "", runs=3)
    records["q4_dist_execute_many"] = {
        "discount_members": d_disc, "config2_members": d_cfg2, "batch_fallbacks": fallbacks, "batches": batches,
        "exact": True, "batched_wall_ms": many_ms["median_ms"], "batched_runs_ms": many_ms["runs_ms"],
        "sequential_wall_ms": one_ms["median_ms"], "sequential_runs_ms": one_ms["runs_ms"]}
    log("batch_check", item="q4_dist_execute_many", **records["q4_dist_execute_many"])

    # (q5) malformed queries fail the plan check before any launch
    bad_sql = ["SELECT FROBNICATE(lo_revenue) FROM lineorder",
               "SELECT SUM(MAX(lo_revenue)) FROM lineorder",
               "SELECT POWER(lo_quantity) FROM lineorder"]
    before = _scan_counts()
    codes = {}
    for name, run in (("segment_engine", seg["engine"].query), ("distributed_engine", engine.query),
                      ("multi_stage_engine", lambda q: engine.query(
                          q.replace("FROM lineorder", "FROM lineorder JOIN dates ON lo_orderdate = d_datekey")))):
        for q in bad_sql:
            try:
                run(q)
            except PlanCheckError as exc:
                codes.setdefault(name, []).append(exc.code)
            else:
                raise AssertionError(f"(q5) {name} ran the malformed {q!r}")
    d = _scan_delta(before)
    counted.append(d)
    if d["launches"] != 0:
        raise AssertionError(f"(q5) the malformed queries launched the scan: {d}")
    records["q5_plan_check"] = {"codes": codes, "launches": d["launches"]}
    log("batch_check", item="q5_plan_check", **records["q5_plan_check"])

    # (q6) the named plan caches
    counters = METRICS.snapshot()["counters"]
    records["q6_plan_caches"] = {
        name: {**stats, **{k: counters.get(f"{name}.{k}", 0) for k in ("hits", "misses", "evictions")}}
        for name, stats in named_cache_stats().items() if name.startswith("compile.")}
    log("batch_check", item="q6_plan_caches", caches=records["q6_plan_caches"])
    for name in ("compile.sse", "compile.dist", "compile.batch", "compile.batch.dist"):
        if name not in records["q6_plan_caches"]:
            raise AssertionError(f"(q6) no named cache {name}")

    launches = sum(c["launches"] for c in counted)
    variants, member_axis, layouts = {}, {}, {}
    for c in counted:
        for k, v in c["instantiations"].items():
            variants[k] = variants.get(k, 0) + v
        for k, v in c["member_axis_launches"].items():
            member_axis[k] = member_axis.get(k, 0) + v
        for k, v in c["layouts"].items():
            layouts[k] = layouts.get(k, 0) + v
    profiles = [("batch_profile", {"engine": "server", "query": "q2_batch"}, _Call(batch), ""),
                ("batch_profile", {"engine": "server", "query": "q2_sequential"},
                 _Call(lambda: [execute(_batch_q(k)) for k in ks]), ""),
                ("batch_profile", {"engine": "dist", "query": "q4_execute_many"},
                 _Call(lambda: engine.execute_many([parse_query(_batch_disc_q(k)) for k in dks])), "")]
    return {"launches": launches, "variants": variants, "member_axis_launches": member_axis,
            "member_axis_layouts": layouts, "records": records,
            "profiles": profiles, "engine": engine, "server": server, "batch_s": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# phase 4k: cluster_path — the coordinator, the broker, the durable and
# highly available control plane over phase 4's segments
# ---------------------------------------------------------------------------
CLUSTER_SERVERS = 3
CLUSTER_REPLICATION = 2
# phase 4's segments the durable cluster of (k4) holds (its reduced depth)
CLUSTER_DURABLE_SEGMENTS = 2
CLUSTER_LEASE_TTL_S = 2.0
# warm runs of (k1) a side, in turns
CLUSTER_WALL_RUNS = 9
CLUSTER_ROUTES = ("y3_union_all", "y2_in_subquery", "y4_explain", "y4_explain_analyze")


class _SimClock:
    """The lease's injected clock: (k4)'s lease expires by advancing it."""

    def __init__(self):
        self.t = 0.0

    def __call__(self) -> float:
        return self.t

    def advance(self, s: float) -> None:
        self.t += s


def _span_tree(node, out=None):
    """Span name -> [ms, ...] over a trace tree."""
    out = {} if out is None else out
    out.setdefault(node["name"].split(":")[0], []).append(node.get("ms"))
    for c in node.get("children", ()):
        if isinstance(c, dict):
            _span_tree(c, out)
    return out


def _first_routed(broker, table: str, seg_name: str) -> str:
    """The replica the broker's next query routes `seg_name` to (its
    balanced selector: the next round-robin slot among the healthy,
    non-browned replicas), so a fault can be scripted onto that call."""
    view = broker.coordinator.external_view(table)
    cands = sorted(s for s in view[seg_name] if broker.health.available(s))
    bright = [c for c in cands if not broker.health.brownout_deprioritized(c)] or cands
    return bright[(broker._rr + 1) % len(bright)]


def _cluster_counted(label, run, want, launches, counted, instantiations=None):
    """One counted run: counts read around it, the answer against `want`
    (sorted rows), the launches against `launches`."""
    before = _scan_counts()
    out = run()
    torch.cuda.synchronize()
    d = _scan_delta(before)
    counted.append(d)
    if want is not None and sorted(out.rows) != want:
        raise AssertionError(f"({label}) is not exact: {sorted(out.rows)[:3]} vs {want[:3]}")
    if d["launches"] != launches or (instantiations is not None and d["instantiations"] != instantiations):
        raise AssertionError(f"({label}) launches: {d}, want {launches} {instantiations or ''}")
    return out, d


def _durable_cluster(seg, root, counted):
    """(k4): the durable, highly available control plane at reduced depth;
    the servers' staging threads stop at the end."""
    from pinot_tpu_torch.cluster import ServerInstance

    servers = [ServerInstance(f"d{i}", data_dir=os.path.join(root, f"d{i}")) for i in range(CLUSTER_SERVERS + 1)]
    try:
        return _durable_steps(seg, root, counted, servers)
    finally:
        for srv in servers:
            if srv.residency is not None:
                srv.residency.shutdown()


def _durable_steps(seg, root, counted, servers):
    """(k4)'s steps: the last of `servers` joins before the rebalance."""
    from pinot_tpu_torch.cluster import Broker, Coordinator, CoordinatorHandle, FaultPlan

    t0 = time.perf_counter()
    table = seg["engine"].table("lineorder")
    segments = table.query_segments()[:CLUSTER_DURABLE_SEGMENTS]
    cnt, rev = _od_tables(seg["datas"][:CLUSTER_DURABLE_SEGMENTS], "lo_quantity", 51)
    want = _od_rows(cnt, rev, 1, 25)
    n = len(segments)
    clock = _SimClock()
    meta, deep = os.path.join(root, "meta"), os.path.join(root, "deep")
    leader = Coordinator(replication=CLUSTER_REPLICATION, meta_dir=meta, deep_store=deep, node_id="coord-a",
                         lease_ttl_s=CLUSTER_LEASE_TTL_S, clock=clock)
    handle = CoordinatorHandle([leader], sleep=clock.advance, clock=clock)
    for srv in servers[:-1]:
        handle.register_server(srv)
    handle.add_table(table.schema, table.config)
    t_up = time.perf_counter()
    for s in segments:
        handle.add_segment("lineorder", s)
    upload_s = time.perf_counter() - t_up
    stored = leader.deep_store.list_segments("lineorder")
    if stored != sorted(s.name for s in segments):
        raise AssertionError(f"(k4) the deep store holds {stored}")
    broker = Broker(handle)
    steps = {}
    _cluster_counted("k4 loaded", lambda: broker.query(CONFIG2), want, n, counted)

    # a crashed server restarts from the deep store, CRC-verified
    victim = next(s for s in sorted(leader.servers) if leader.servers[s].segment_names("lineorder"))
    owned = sorted(leader.servers[victim].segment_names("lineorder"))
    handle.crash_server(victim)
    _cluster_counted("k4 crashed", lambda: broker.query(CONFIG2), want, n, counted)
    t_re = time.perf_counter()
    restored = handle.restart_server(victim)
    restart_s = time.perf_counter() - t_re
    srv = leader.servers[victim]
    local = [os.path.realpath(srv.get_segment("lineorder", name).source_dir) for name in owned]
    if restored != {"restored": len(owned), "dropped": 0, "missing": 0} or not all(
            p.startswith(os.path.realpath(os.path.join(root, victim))) for p in local):
        raise AssertionError(f"(k4) the restart did not restore from the deep store: {restored}, {local}")
    _cluster_counted("k4 restarted", lambda: broker.query(CONFIG2), want, n, counted)
    steps["restart"] = {"server": victim, "segments": owned, "restart_s": restart_s}

    # the lease expires; the hot standby promotes while the broker serves
    standby = Coordinator(replication=CLUSTER_REPLICATION, meta_dir=meta, deep_store=deep, node_id="coord-b",
                          standby=True, lease_ttl_s=CLUSTER_LEASE_TTL_S, clock=clock)
    handle.add_candidate(standby)
    plan = FaultPlan(seed=7).attach_coordinator(leader)
    plan.attach_coordinator(standby)
    plan.pause_leader("coord-a")
    t_clock = clock.t
    _cluster_counted("k4 leaderless", lambda: broker.query(CONFIG2), want, n, counted)
    if clock.t != t_clock:
        raise AssertionError("(k4) a data-plane query parked behind the election")
    handle.heartbeat(victim)  # a control-plane call: parks until the standby promotes
    if standby.role != "leader" or standby.election.epoch != 2:
        raise AssertionError(f"(k4) no failover: standby {standby.role} epoch {standby.election.epoch}")
    _cluster_counted("k4 promoted", lambda: broker.query(CONFIG2), want, n, counted)
    steps["failover"] = {"epoch": standby.election.epoch, "parked_s_simulated": clock.t - t_clock,
                         "leader": handle.election_snapshot()["leader"]}

    # a fourth server joins; rebalance moves segments while a thread queries
    joined = servers[-1]
    handle.register_server(joined)
    stop, answers, errors = threading.Event(), [], []

    def query_loop():
        while not stop.is_set():
            try:
                answers.append(sorted(broker.query(CONFIG2).rows) == want)
            except Exception as exc:  # the phase fails on it below
                errors.append(repr(exc))
                return

    before = _scan_counts()
    worker = threading.Thread(target=query_loop, name="k4-queries")
    worker.start()
    try:
        while not answers and not errors:
            time.sleep(0.001)  # at least one answer lands before the moves start
        report = handle.rebalance("lineorder")
        mid = len(answers)
        while len(answers) < mid + 1 and not errors:
            time.sleep(0.001)  # and one after the last move
    finally:
        stop.set()
        worker.join()
    torch.cuda.synchronize()
    d = _scan_delta(before)
    counted.append(d)
    if errors or not all(answers) or report["segmentsMoved"] < 1 or not joined.segment_names("lineorder"):
        raise AssertionError(f"(k4) rebalance under queries: {report}, {errors}, exact {answers}")
    if d["launches"] < n * len(answers):
        raise AssertionError(f"(k4) {d['launches']} launches for {len(answers)} queries of {n} segments")
    _cluster_counted("k4 rebalanced", lambda: broker.query(CONFIG2), want, n, counted)
    steps["rebalance"] = {**report, "queries_during": len(answers), "launches_during": d["launches"],
                          "joined_holds": sorted(joined.segment_names("lineorder")),
                          "ideal": {k: sorted(v) for k, v in standby.tables["lineorder"].ideal.items()}}
    if broker.hedge_drain() != 0:
        raise AssertionError("(k4) hedge threads outlived the item")
    return {"segments": n, "rows": sum(s.num_docs for s in segments), "upload_s": upload_s,
            "deep_store_bytes": sum(os.path.getsize(os.path.join(dp, f)) for dp, _, fs in os.walk(deep) for f in fs),
            "steps": steps, "exact": True, "k4_s": time.perf_counter() - t0}


def phase_cluster_path(seg, front, batch=None):
    """Phase 4k: (k1)-(k5), each counted run exact against numpy; returns the
    counted runs' launches, the records and the profile to run.  `batch`
    (phase 4j's result) puts (q1)'s ServerInstance.execute wall beside
    (k1)'s."""
    from pinot_tpu_torch.cluster import Broker, Coordinator, FaultPlan, ServerInstance
    from pinot_tpu_torch.ops import fused_scan
    from pinot_tpu_torch.query.reduce import reduce_results
    from pinot_tpu_torch.sql.parser import parse_query

    t0 = time.perf_counter()
    fused_scan.reset_counters()
    counted, records = [], {}
    engine = seg["engine"]
    table = engine.table("lineorder")
    segments = table.query_segments()
    n = len(segments)
    want2 = seg["golden"]["a_config2"]
    p16 = {"p16/i32/shared": n}

    # (k1) config 2 through the broker, full width and depth
    coord = Coordinator(replication=CLUSTER_REPLICATION)
    for i in range(CLUSTER_SERVERS):
        coord.register_server(ServerInstance(f"k{i}"))
    coord.add_table(table.schema, table.config)
    for s in segments:
        coord.add_segment("lineorder", s)
    broker = Broker(coord)
    _out, d = _cluster_counted("k1", lambda: broker.query(CONFIG2), want2, n, counted, p16)
    if d["member_axis_launches"]:
        raise AssertionError(f"(k1) member-axis launches in a single query: {d}")
    # the same segments on one server without the broker, registered with a
    # coordinator of its own so it carries the same budget and residency
    direct = ServerInstance("k_direct")
    Coordinator().register_server(direct)
    for s in segments:
        direct.add_segment("lineorder", s)
    names = direct.segment_names("lineorder")

    def server_execute():
        ctx = parse_query(CONFIG2)
        res, st = direct.execute(ctx, names)
        return reduce_results(ctx, res, st)

    if sorted(server_execute().rows) != want2:
        raise AssertionError("(k1) ServerInstance.execute over the 8 segments is not exact")
    broker_runs, server_runs = [], []
    for _ in range(CLUSTER_WALL_RUNS):  # in turns: the broker, then the server alone
        broker_runs += _wall_ms(broker, CONFIG2, runs=1)["runs_ms"]
        server_runs += _wall_ms(_Call(server_execute), "", runs=1)["runs_ms"]
    traced, _d = _cluster_counted("k1 traced", lambda: broker.query("SET trace = true; " + CONFIG2), want2, n,
                                  counted, p16)
    spans = _span_tree(traced.stats.trace)
    for name in ("plan", "prune", "server_execute"):
        if name not in spans:
            raise AssertionError(f"(k1) the broker's trace has no {name} span: {sorted(spans)}")
    records["k1_broker_config2"] = {
        **d, "exact": True, "servers": CLUSTER_SERVERS, "replication": CLUSTER_REPLICATION, "rows": int(
            sum(s.num_docs for s in segments)), "broker_wall_ms": statistics.median(broker_runs),
        "broker_runs_ms": broker_runs, "server_execute_wall_ms": statistics.median(server_runs),
        "server_execute_runs_ms": server_runs,
        "broker_host_ms": statistics.median(broker_runs) - statistics.median(server_runs),
        "q1_server_execute_wall_ms": batch["records"]["q1_server_execute"]["wall_ms"] if batch else "not run",
        "traced_spans_ms": {k: spans[k] for k in ("plan", "prune", "scatter", "server_execute", "reduce")
                            if k in spans},
        "routing": {s: sorted(v) for s, v in coord.external_view("lineorder").items()}}
    log("cluster_check", item="k1_broker_config2", **records["k1_broker_config2"])

    # (k2) the first-routed replica crashes on its call: failover, then heal
    victim = _first_routed(broker, "lineorder", next(iter(coord.tables["lineorder"].ideal)))
    plan = FaultPlan(seed=11).crash_server(victim, on_call=1).attach(coord)
    out, d = _cluster_counted("k2 failover", lambda: broker.query(CONFIG2), want2, n, counted, p16)
    failures, state = broker.health.consecutive_failures(victim), broker.health.state(victim)
    if [k for (_, _, k, _) in plan.log] != ["crash"] or failures != 1 or victim in coord.live or (
            out.stats.partial_result or not any(e.get("server") == victim for e in out.stats.exceptions)):
        raise AssertionError(f"(k2) {victim}: log {plan.log}, failures {failures}, exceptions {out.stats.exceptions}")
    restored = coord.restart_server(victim)
    if broker.health.state(victim) != "closed" or broker.health.consecutive_failures(victim) != 0:
        raise AssertionError(f"(k2) restart did not heal {victim}'s breaker: {broker.health.state(victim)}")
    _cluster_counted("k2 healed", lambda: broker.query(CONFIG2), want2, n, counted, p16)
    records["k2_failover"] = {**d, "exact": True, "victim": victim, "breaker_after_crash": state,
                              "failures_recorded": failures, "restart": restored,
                              "exceptions": [e["errorCode"] for e in out.stats.exceptions],
                              "servers_queried": out.stats.num_servers_queried,
                              "servers_responded": out.stats.num_servers_responded}
    log("cluster_check", item="k2_failover", **records["k2_failover"])

    # (k3) (q2)'s 8 members through query_many: the member-axis launch
    ks = list(range(18, 18 + BATCH_W))
    q_cnt, q_rev = _od_tables(seg["datas"], "lo_quantity", 51)
    broker.batch_clock = lambda: 0.0  # one group: flushed by query_many's drain, not a timer
    before = _scan_counts()
    outs = broker.query_many([_batch_q(k) for k in ks])
    torch.cuda.synchronize()
    d = _scan_delta(before)
    counted.append(d)
    for k, o in zip(ks, outs):
        if sorted(o.rows) != _od_rows(q_cnt, q_rev, 1, k):
            raise AssertionError(f"(k3) member lo_quantity < {k} is not exact")
    if (d["launches"], sum(d["member_axis_launches"].values()), d["members"], d["layouts"]) != (
            n, n, BATCH_W * n, {f"{BATCH_W}/{BATCH_W}": n}):
        raise AssertionError(f"(k3) query_many did not take the member axis once a segment: {d}")
    many_ms = _wall_ms(_Call(lambda: broker.query_many([_batch_q(k) for k in ks])), "", runs=3)
    records["k3_query_many"] = {**d, "exact": True, "member_axis_layouts": d["layouts"],
                                "wall_ms": many_ms["median_ms"], "runs_ms": many_ms["runs_ms"]}
    log("cluster_check", item="k3_query_many", **records["k3_query_many"])

    # (k4) the durable, highly available control plane at reduced depth
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="cluster_", dir=os.path.join(REPO, "build"))
    try:
        records["k4_durable"] = _durable_cluster(seg, root, counted)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    log("cluster_check", item="k4_durable", **records["k4_durable"])

    # (k5) the routes only the broker has, against phase 4g's goldens and
    # the segment engine's answers
    golden = front["seg_golden"]
    for name in CLUSTER_ROUTES:
        sql = FRONT_DOOR_QUERIES[name]
        out, d = _cluster_counted(f"k5 {name}", lambda: broker.query(sql), None,
                                  FRONT_DOOR_SEG_SCANS[name] * n, counted)
        mine = engine.query(sql)
        if name.startswith("y4_"):
            ops, theirs = [r[0] for r in out.rows], [r[0] for r in mine.rows]
            if ops[:5] != theirs[:5] or (name == "y4_explain" and out.rows != mine.rows):
                raise AssertionError(f"(k5) {name}: {ops[:5]} vs the segment engine's {theirs[:5]}")
        elif not _front_door_exact(name, out, golden[name]) or sorted(map(tuple, out.rows)) != sorted(
                map(tuple, mine.rows)):
            raise AssertionError(f"(k5) {name} is not exact")
        records[f"k5_{name}"] = {**d, "exact": True, "rows": len(out.rows)}
        log("cluster_check", item=f"k5_{name}", **records[f"k5_{name}"])

    alive = broker.hedge_drain()
    if alive:
        raise AssertionError(f"{alive} hedge threads outlived phase 4k")
    launches = sum(c["launches"] for c in counted)
    variants, member_axis, layouts = {}, {}, {}
    for c in counted:
        for src, dst in ((c["instantiations"], variants), (c["member_axis_launches"], member_axis),
                         (c["layouts"], layouts)):
            for k, v in src.items():
                dst[k] = dst.get(k, 0) + v
    profiles = [("cluster_profile", {"engine": "broker", "query": "k1_config2"}, broker, CONFIG2)]
    return {"launches": launches, "variants": variants, "member_axis_launches": member_axis,
            "member_axis_layouts": layouts, "records": records, "profiles": profiles,
            "servers": list(coord.servers.values()) + [direct], "coord": coord, "broker": broker, "direct": direct,
            "segments": segments, "cluster_s": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# phase 4l: serving_path — the REST query server, the command-line tool,
# minion tasks and a materialized view over phase 4k's cluster
# ---------------------------------------------------------------------------
# warm runs a side of (l1)'s and (l4)'s in-turn walls and of (l5)
SERVING_WALL_RUNS = 9
SERVING_CLIENTS = 8
SERVING_CURSOR_PAGE = 30
# (l2)'s CSV: cut from a segment's 2^23 rows for the script's limit
SERVING_CSV_ROWS = 1 << 22
# (l3): two sealed segments of RT_SEGMENT_ROWS and a consuming tail
SERVING_RT_MESSAGES = 2 * RT_SEGMENT_ROWS + (RT_SEGMENT_ROWS >> 1)
SERVING_T0 = 1_700_000_000_000
# (l4)'s ninth segment, which makes the view stale
SERVING_NINTH_ROWS = 1 << 20
SERVING_BAD_SQL = "SELECT SUM(MAX(lo_revenue)) FROM lineorder"
# the top-level keys of each /debug view (the JAX payloads' keys)
SERVING_DEBUG_KEYS = {"/debug/queries": {"queries"},
                      "/debug/admission": {"pressureLevel", "admission", "hostBudget", "watchdog"},
                      "/debug/perf": {"window", "tables", "caches"},
                      "/debug/autopilot": {"enabled", "knobs"},
                      "/debug/election": {"leader", "candidates"}}


def _json_rows(payload):
    """A REST payload's rows as sorted tuples (JSON lists of numbers)."""
    return sorted(tuple(r) for r in payload["resultTable"]["rows"])


def _http(url: str, body=None):
    """(status, parsed JSON or text) of one GET (body None) or POST."""
    import urllib.error
    import urllib.request

    data = None if body is None else json.dumps(body).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            status, ctype, text = r.status, r.headers.get("Content-Type", ""), r.read().decode()
    except urllib.error.HTTPError as e:
        status, ctype, text = e.code, e.headers.get("Content-Type", ""), e.read().decode()
    return status, json.loads(text) if ctype.startswith("application/json") else text


def _counted(counted, fn):
    """fn() with the scan counts read around it; the delta is kept."""
    before = _scan_counts()
    out = fn()
    torch.cuda.synchronize()
    d = _scan_delta(before)
    counted.append(d)
    return out, d


def _cli(argv):
    """(exit code, stdout, stderr) of one in-process `cli.main(argv)`."""
    import contextlib
    import io

    from pinot_tpu_torch.tools import cli

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    return rc, out.getvalue(), err.getvalue()


def _serving_rest(seg, cluster, counted):
    """(l1): config 2, a cursor, the metrics and debug views and the error
    mapping over HTTP; returns the record and the running server."""
    from pinot_tpu_torch.cluster import FaultPlan
    from pinot_tpu_torch.cluster.rest import PinotClient, QueryServer, _jsonable

    broker, coord = cluster["broker"], cluster["coord"]
    want2, n = seg["golden"]["a_config2"], len(cluster["segments"])
    srv = QueryServer(broker).start()  # 127.0.0.1, a free port
    base = f"http://127.0.0.1:{srv.port}"
    client = PinotClient(base)
    rec = {"url": base}
    try:
        resp, d = _counted(counted, lambda: client.execute(CONFIG2))
        if _json_rows(resp) != want2 or d["instantiations"] != {"p16/i32/shared": n} or d["launches"] != n:
            raise AssertionError(f"(l1) config 2 over HTTP: exact {_json_rows(resp) == want2}, {d}")
        http_runs, broker_runs = [], []
        for _ in range(SERVING_WALL_RUNS):  # in turns: over HTTP, then Broker.query
            http_runs += _wall_ms(_Call(lambda: client.execute(CONFIG2)), "", runs=1)["runs_ms"]
            broker_runs += _wall_ms(broker, CONFIG2, runs=1)["runs_ms"]
        rec["config2"] = {**d, "exact": True, "numDocsScanned": resp["numDocsScanned"],
                          "http_wall_ms": statistics.median(http_runs), "http_runs_ms": http_runs,
                          "broker_wall_ms": statistics.median(broker_runs), "broker_runs_ms": broker_runs,
                          "http_json_ms": statistics.median(http_runs) - statistics.median(broker_runs)}

        # a top-100 selection paged through a cursor to its end
        sql = TRANSFORM_QUERIES["h_selection_top"]
        first, d = _counted(counted, lambda: client.execute(sql, useCursor=True, pageSize=SERVING_CURSOR_PAGE))
        cid, rows = first["cursorId"], []
        page = client.fetch_cursor(cid, 0)
        for p in range(page["numPages"]):
            rows += client.fetch_cursor(cid, p)["rows"]
        mine = [[_jsonable(v) for v in r] for r in seg["engine"].query(sql).rows]
        if rows != mine or first["resultTable"]["rows"] != rows[:SERVING_CURSOR_PAGE] or not rows:
            raise AssertionError(f"(l1) the cursor's {len(rows)} rows differ from the segment engine's")
        rec["cursor"] = {**d, "exact": True, "rows": len(rows), "pages": page["numPages"]}

        # metrics, federated over the three servers, and the debug views
        code, text = _http(base + "/metrics?format=prometheus")
        servers = sorted(coord.servers)
        if code != 200 or not all(f'server="{s}"' in text for s in servers) or "pinot_cluster_" not in text:
            raise AssertionError(f"(l1) /metrics?format=prometheus does not federate {servers}")
        code, snap = _http(base + "/metrics")
        if code != 200 or sorted(snap["servers"]["perServer"]) != servers:
            raise AssertionError(f"(l1) /metrics: {code}, {sorted(snap.get('servers', {}))}")
        rec["metrics"] = {"prometheus_lines": len(text.splitlines()), "servers": servers,
                          "cluster_server_queries": snap["servers"]["cluster"]["counters"].get("server.queries")}
        rec["debug"] = {}
        for path, keys in SERVING_DEBUG_KEYS.items():
            code, payload = _http(base + path)
            if code != 200 or not keys <= set(payload):
                raise AssertionError(f"(l1) {path}: {code}, keys {sorted(payload)}")
            rec["debug"][path] = sorted(payload)

        # the error mapping: plan check, deadline, quota, every replica down
        errors = {}
        (code, payload), d = _counted(counted, lambda: _http(base + "/query/sql", {"sql": SERVING_BAD_SQL}))
        if code != 400 or payload.get("errorCode") != "NESTED_AGGREGATION" or d["launches"]:
            raise AssertionError(f"(l1) malformed query: {code} {payload}, {d['launches']} launches")
        errors["plan_check"] = {"status": code, "errorCode": payload["errorCode"], "launches": d["launches"]}
        (code, payload), d = _counted(counted, lambda: _http(base + "/query/sql",
                                                            {"sql": "SET timeoutMs = 0; " + CONFIG2}))
        if code != 408 or payload.get("errorCode") != "EXECUTION_TIMEOUT_ERROR":
            raise AssertionError(f"(l1) expired deadline: {code} {payload}")
        errors["timeout"] = {"status": code, "errorCode": payload["errorCode"], "launches": d["launches"]}
        cfg, clock = coord.tables["lineorder"].config, broker.quota.clock
        cfg.max_queries_per_second, broker.quota.clock = 1.0, lambda: 1e9  # one token, never refilled
        try:
            (answers, d) = _counted(counted, lambda: [_http(base + "/query/sql", {"sql": CONFIG2}) for _ in range(2)])
        finally:
            cfg.max_queries_per_second, broker.quota.clock = 0.0, clock
        (c1, p1), (c2, p2) = answers
        if c1 != 200 or _json_rows(p1) != want2 or c2 != 429 or p2.get("errorCode") != "QUERY_QUOTA_EXCEEDED":
            raise AssertionError(f"(l1) table quota: {c1}, then {c2} {p2}")
        errors["quota"] = {"status": [c1, c2], "errorCode": p2["errorCode"], "launches": d["launches"]}
        victims = sorted(coord.tables["lineorder"].ideal[cluster["segments"][0].name])
        plan = FaultPlan(seed=13)
        for v in victims:
            plan.always_fail(v)
        plan.attach(coord)
        try:
            (code, payload), d = _counted(counted, lambda: _http(base + "/query/sql", {"sql": CONFIG2}))
        finally:
            for s in coord.servers.values():
                s.fault_plan = None
            coord.fault_plan = None
            for v in victims:
                broker.health.reset(v)
        if (code, payload.get("errorCode")) not in ((503, "NO_REPLICA_AVAILABLE"), (500, "SERVER_SCATTER_ERROR")):
            raise AssertionError(f"(l1) every replica of a segment failing: {code} {payload}")
        errors["replicas_down"] = {"victims": victims, "status": code, "errorCode": payload["errorCode"],
                                   "launches": d["launches"]}
        healed, d = _counted(counted, lambda: client.execute(CONFIG2))
        if _json_rows(healed) != want2 or d["launches"] != n:
            raise AssertionError(f"(l1) config 2 after the faults were lifted: {d}")
        rec["errors"] = errors

        # eight clients at once
        got, failures = [None] * SERVING_CLIENTS, []

        def one(i):
            try:
                got[i] = _json_rows(client.execute(CONFIG2))
            except Exception as exc:  # the phase fails on it below
                failures.append(repr(exc))

        def clients():
            threads = [threading.Thread(target=one, args=(i,)) for i in range(SERVING_CLIENTS)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=600)
            return [t.is_alive() for t in threads]

        t0 = time.perf_counter()
        alive, d = _counted(counted, clients)
        wall_ms = (time.perf_counter() - t0) * 1e3
        if any(alive) or failures or any(g != want2 for g in got) or d["launches"] != SERVING_CLIENTS * n:
            raise AssertionError(f"(l1) concurrent clients: {failures}, exact {[g == want2 for g in got]}, {d}")
        rec["concurrent"] = {**d, "clients": SERVING_CLIENTS, "exact": True, "wall_ms": wall_ms}
    except BaseException:
        srv.stop()
        raise
    return rec, srv


def _write_csv(path: str, d) -> None:
    """Column arrays -> one CSV file with a header row."""
    names = list(d)
    with open(path, "w", encoding="utf-8") as f:
        f.write(",".join(names) + "\n")
        f.write("\n".join(",".join(map(str, r)) for r in zip(*(d[k].tolist() for k in names))))
        f.write("\n")


def _columns_equal(a, b) -> bool:
    """Two segments' columns hold the same stored bytes: dictionary values,
    codes or raw values, the packed lanes and their width, the decoded
    values."""
    for f in a.schema.fields:
        x, y = a.column(f.name), b.column(f.name)
        if (x.dictionary is None) != (y.dictionary is None) or x.code_bits != y.code_bits:
            return False
        if x.dictionary is not None and not np.array_equal(x.dictionary.values, y.dictionary.values):
            return False
        for u, v in ((x.codes, y.codes), (x.values, y.values), (x.packed, y.packed)):
            if (u is None) != (v is None) or (u is not None and not np.array_equal(u, v)):
                return False
        if not np.array_equal(x.decoded(), y.decoded()):
            return False
    return True


def _cli_rows(out: str):
    """`cli query`'s tab-separated config-2 rows, sorted."""
    return sorted((int(a), float(b), int(c)) for a, b, c in (line.split("\t") for line in out.splitlines()[1:]))


def _bench_record(scale: float):
    """A synthetic bench-history record (utils/perf.bench_record's form)."""
    return {"schema": 1, "bench": "ssb_groupby", "backend": "cuda", "rows": 1 << 27,
            "metrics": {"kernel_rows_per_sec": 3.2e11 * scale, "e2e_rows_per_sec": 9.0e9 * scale},
            "noise": {"run_variance": 0.02}}


def _serving_cli(seg, rest_url, root, rng, counted):
    """(l2): create-segment from a CSV, query on the card, serve in a child
    process, the endpoint commands against (l1)'s server, perf --check,
    quickstart."""
    import pinot_tpu_torch.ingest as ingest
    from pinot_tpu_torch.ops import _build
    from pinot_tpu_torch.segment.builder import build_segment
    from pinot_tpu_torch.segment.segment import ImmutableSegment
    from pinot_tpu_torch.utils import perf

    rec = {}
    table = seg["engine"].table("lineorder")
    d = lineorder_segment(rng, SERVING_CSV_ROWS)
    sums, cnts = _config2_tables(d)
    want = _config2_rows(sums, cnts)
    paths = {k: os.path.join(root, k) for k in ("schema.json", "table.json", "lineorder.csv", "seg", "serve.err")}
    with open(paths["schema.json"], "w", encoding="utf-8") as f:
        json.dump(table.schema.to_dict(), f)
    with open(paths["table.json"], "w", encoding="utf-8") as f:
        json.dump(table.config.to_dict(), f)
    t0 = time.perf_counter()
    _write_csv(paths["lineorder.csv"], d)
    write_s = time.perf_counter() - t0

    # create-segment, with the parse timed inside the command
    parse, orig = {}, ingest.read_csv_columns

    def timed_parse(*a, **kw):
        t = time.perf_counter()
        out = orig(*a, **kw)
        parse["s"] = time.perf_counter() - t
        return out

    ingest.read_csv_columns = timed_parse
    try:
        t0 = time.perf_counter()
        rc, out, err = _cli(["create-segment", "--schema", paths["schema.json"], "--csv", paths["lineorder.csv"],
                             "--out", paths["seg"], "--table-config", paths["table.json"], "--name", "csv_0"])
        create_s = time.perf_counter() - t0
    finally:
        ingest.read_csv_columns = orig
    built = ImmutableSegment.load(paths["seg"])
    direct = build_segment(table.schema, dict(d), "csv_0", table_config=table.config)
    if rc != 0 or built.num_docs != SERVING_CSV_ROWS or not _columns_equal(built, direct):
        raise AssertionError(f"(l2) create-segment: rc {rc}, {built.num_docs} docs, {err[-500:]}")
    rec["create_segment"] = {"rows": SERVING_CSV_ROWS, "csv_bytes": os.path.getsize(paths["lineorder.csv"]),
                             "csv_write_s": write_s, "parse_s": parse["s"], "create_s": create_s,
                             "build_and_save_s": create_s - parse["s"],
                             "parse_rows_per_s": SERVING_CSV_ROWS / parse["s"],
                             "create_rows_per_s": SERVING_CSV_ROWS / create_s, "columns_equal_build_segment": True,
                             "output": out.strip()}

    # serve in a process of its own, started now: it boots while the
    # commands below run
    lib = os.path.join(str(_build.BUILD_DIR), _build.LIB_NAME)
    lib_stat = os.stat(lib).st_mtime_ns
    err_f = open(paths["serve.err"], "w", encoding="utf-8")
    t_serve = time.perf_counter()
    child = subprocess.Popen([sys.executable, "-m", "pinot_tpu_torch.tools.cli", "serve", "--segments",
                              paths["seg"], "--port", "0"], cwd=REPO, stdout=subprocess.PIPE, stderr=err_f, text=True)
    try:
        first_line = []
        reader = threading.Thread(target=lambda: first_line.append(child.stdout.readline()), daemon=True)
        reader.start()

        # query on the card (no --device: the default)
        (rc, out, err), dq = _counted(counted, lambda: _cli(["query", "--segments", paths["seg"], "--sql", CONFIG2]))
        if rc != 0 or _cli_rows(out) != want or dq["launches"] != 1:
            raise AssertionError(f"(l2) cli query: rc {rc}, exact {rc == 0 and _cli_rows(out) == want}, {dq}")
        rec["query"] = {**dq, "exact": True, "rows": len(want), "summary": err.strip()}

        # the endpoint commands against (l1)'s server
        rec["endpoints"] = {}
        for cmd in (["slow-queries", "--limit", "5"], ["admission"], ["election"], ["autopilot"], ["perf"]):
            rc, out, err = _cli(cmd + ["--url", rest_url])
            if rc != 0 or not out.strip():
                raise AssertionError(f"(l2) cli {cmd[0]}: rc {rc}, {err[-300:]}")
            rec["endpoints"][cmd[0]] = {"rc": rc, "lines": len(out.splitlines()), "first": out.splitlines()[0]}

        # perf --check over a synthetic history and baseline under build/
        base = os.path.join(root, "baseline.json")
        with open(base, "w", encoding="utf-8") as f:
            json.dump(_bench_record(1.0), f)
        rec["perf_check"] = {}
        for name, scale, expect in (("healthy", 1.02, 0), ("regression", 0.75, 1)):
            hist = os.path.join(root, f"history_{name}.jsonl")
            perf.append_bench_history(hist, _bench_record(scale))
            rc, out, err = _cli(["perf", "--check", "--history", hist, "--baseline", base])
            if rc != expect or ("FAIL" in out) != bool(expect):
                raise AssertionError(f"(l2) perf --check {name}: rc {rc}, {out}")
            rec["perf_check"][name] = {"rc": rc, "verdict": err.strip()}

        # quickstart on the card
        (rc, out, err), d = _counted(counted, lambda: _cli(["quickstart"]))
        lines = out.splitlines()
        if rc != 0 or lines[lines.index("> SELECT COUNT(*) FROM demo") + 2] != "100000":
            raise AssertionError(f"(l2) quickstart: rc {rc}, {d}, {out[:300]}")
        rec["quickstart"] = {**d, "rc": rc, "lines": len(lines)}

        # the served process answers over HTTP, then stops on SIGINT
        reader.join(timeout=300)
        line = first_line[0] if first_line else ""
        if not line.startswith("query server listening on http://127.0.0.1:"):
            raise AssertionError(f"(l2) serve did not start: {line!r}, exit {child.poll()}")
        boot_s = time.perf_counter() - t_serve
        url = line.split()[-1]
        t0 = time.perf_counter()
        code, payload = _http(url, {"sql": CONFIG2})
        first_ms = (time.perf_counter() - t0) * 1e3
        if code != 200 or _json_rows(payload) != want:
            raise AssertionError(f"(l2) serve's answer: {code}, exact {code == 200 and _json_rows(payload) == want}")
        runs = [_wall_ms(_Call(lambda: _http(url, {"sql": CONFIG2})), "", runs=1)["runs_ms"][0] for _ in range(5)]
        child.send_signal(signal.SIGINT)
        rc = child.wait(timeout=120)
        if rc != 0 or os.stat(lib).st_mtime_ns != lib_stat:
            raise AssertionError(f"(l2) serve exited {rc}; the kernel library rebuilt: {os.stat(lib).st_mtime_ns != lib_stat}")
        rec["serve"] = {"exact": True, "url": url, "boot_s": boot_s, "first_query_ms": first_ms,
                        "warm_median_ms": statistics.median(runs), "runs_ms": runs, "exit_code": rc,
                        "launches": "in the child process (its own counters)", "rebuilt_library": False}
    finally:
        if child.poll() is None:
            child.kill()
            child.wait(timeout=60)
        child.stdout.close()
        err_f.close()
    return rec


def _drop_segment(coord, table: str, name: str) -> None:
    """Take one segment out of a table as the minion's swap does: its
    assignment, its holders' copies, its metadata."""
    meta = coord.tables[table]
    for s in meta.ideal.pop(name, set()):
        coord.servers[s].drop_segment(table, name)
    meta.segment_meta.pop(name, None)
    coord._bump_version()


def _serving_minion(cluster, root, rng, counted):
    """(l3): a coordinator-owned realtime lineorder table drained into an
    offline table by RealtimeToOfflineSegmentsTask, then MergeRollupTask and
    PurgeTask on the offline table; exact after every step."""
    from pinot_tpu_torch.cluster.minion import MinionTaskManager
    from pinot_tpu_torch.realtime import InMemoryStream
    from pinot_tpu_torch.spi.config import IndexingConfig, SegmentsConfig, StreamConfig, TableConfig
    from pinot_tpu_torch.spi.schema import DataType, FieldRole, FieldSpec, Schema

    coord, broker = cluster["coord"], cluster["broker"]
    rt, n = "lineorder_rt", SERVING_RT_MESSAGES
    schema = Schema(rt, list(_rt_schema(False).fields) + [FieldSpec("ts", DataType.TIMESTAMP, role=FieldRole.DATE_TIME)])
    cfg = TableConfig(rt, indexing=IndexingConfig(range_index_columns=["lo_quantity"]),
                      segments=SegmentsConfig(time_column="ts"),
                      stream=StreamConfig(stream_type="memory", topic=rt, max_rows_per_segment=RT_SEGMENT_ROWS))
    stream = InMemoryStream(1)
    mgr = coord.add_realtime_table(schema, cfg, os.path.join(root, "rt"), stream=stream)
    d = lineorder_segment(rng, n)
    d["ts"] = SERVING_T0 + np.arange(n, dtype=np.int64)
    t0 = time.perf_counter()
    stream.publish_many(_messages(d), partition=0)
    publish_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    consumed = coord.run_realtime_consumption()
    consume_s = time.perf_counter() - t0
    sealed = len(mgr.sealed[0])
    if consumed != n or sealed != n // RT_SEGMENT_ROWS:
        raise AssertionError(f"(l3) consumed {consumed} of {n}, {sealed} sealed")

    def config2(table, lo, hi, launches, label):
        part = {k: v[lo:hi] for k, v in d.items()}
        out, dd = _counted(counted, lambda: broker.query(CONFIG2.replace("FROM lineorder", f"FROM {table}")))
        if sorted(out.rows) != _config2_rows(*_config2_tables(part)) or dd["launches"] != launches:
            raise AssertionError(f"(l3) {label}: config 2 over {table} rows [{lo}, {hi}): {dd}")
        return dd

    def count(table):
        return int(broker.query(f"SELECT COUNT(*) FROM {table}").rows[0][0])

    rec = {"published": n, "publish_s": publish_s, "consume_s": consume_s, "ingest_rows_per_s": n / consume_s,
           "sealed": sealed, "consuming": n - sealed * RT_SEGMENT_ROWS}
    rec["before"] = config2(rt, 0, n, sealed + 1, "published")
    minion = MinionTaskManager(coord)
    t0 = time.perf_counter()
    moved = minion.run("RealtimeToOfflineSegmentsTask", rt, realtime_manager=mgr,
                       window_end_ms=SERVING_T0 + sealed * RT_SEGMENT_ROWS)
    rto_s = time.perf_counter() - t0
    off, cut = moved["offlineTable"], sealed * RT_SEGMENT_ROWS
    counts = {"realtime": count(rt), "offline": count(off)}
    if len(moved["moved"]) != sealed or counts != {"realtime": n - cut, "offline": cut}:
        raise AssertionError(f"(l3) RealtimeToOffline moved {moved['moved']}, counts {counts}")
    rec["realtime_to_offline"] = {"moved": moved["moved"], "s": rto_s, "counts": counts,
                                  "realtime": config2(rt, cut, n, 1, "realtime tail"),
                                  "offline": config2(off, 0, cut, sealed, "offline")}
    t0 = time.perf_counter()
    merged = minion.run("MergeRollupTask", off, max_rows_per_segment=cut)
    merge_s = time.perf_counter() - t0
    if merged["merged"] != 1 or merged["outputRows"] != cut or len(coord.tables[off].ideal) != 1:
        raise AssertionError(f"(l3) MergeRollupTask: {merged}")
    rec["merge"] = {"inputs": merged["inputs"], "output_rows": merged["outputRows"], "s": merge_s,
                    "config2": config2(off, 0, cut, 1, "merged")}
    t0 = time.perf_counter()
    purged = minion.run("PurgeTask", off, purge_fn=lambda row: row["lo_quantity"] == 50)
    purge_s = time.perf_counter() - t0
    q = d["lo_quantity"][:cut]
    rows = broker.query(f"SELECT COUNT(*), SUM(lo_revenue) FROM {off} WHERE lo_quantity >= 25").rows
    keep = (q >= 25) & (q != 50)
    if (purged["purgedRows"] != int((q == 50).sum()) or count(off) != cut - int((q == 50).sum())
            or [tuple(r) for r in rows] != [(int(keep.sum()), float(d["lo_revenue"][:cut][keep].sum()))]):
        raise AssertionError(f"(l3) PurgeTask: {purged}, {rows}")
    rec["purge"] = {"purged_rows": purged["purgedRows"], "s": purge_s, "config2": config2(off, 0, cut, 1, "purged")}
    for table in (off, rt):  # their segments leave the servers
        coord.drop_table(table)
    return rec


def _serving_mview(seg, cluster, rng, counted):
    """(l4): a materialized view of config 2's dimensions over phase 4's
    table; the rewrite exact, its fallback when stale, and its repair."""
    from pinot_tpu_torch.cluster.mview import MaterializedView, MaterializedViewManager
    from pinot_tpu_torch.segment.builder import build_segment

    coord, broker = cluster["coord"], cluster["broker"]
    table = seg["engine"].table("lineorder")
    want = [(day, int(s), c) for day, s, c in seg["golden"]["a_config2"]]
    n = len(cluster["segments"])
    mgr = MaterializedViewManager(coord, broker)
    mgr.create_view(MaterializedView("lineorder_dq", source_table="lineorder",
                                     dimensions=["lo_orderdate", "lo_quantity"],
                                     metrics=[("count", "*"), ("sum", "lo_revenue")]))
    cells = len(np.unique(np.concatenate([(x["lo_orderdate"] - 19920101) * 51 + x["lo_quantity"]
                                          for x in seg["datas"]])))

    def rewritten(expect, label, launches):
        out, d = _counted(counted, lambda: mgr.query(CONFIG2))
        got = sorted((int(a), int(b), int(c)) for a, b, c in out.rows)  # the view's sums are DOUBLE, below 2^53
        if out.stats.mv_rewrite is not expect or got != want or d["launches"] != launches:
            raise AssertionError(f"(l4) {label}: mv_rewrite {out.stats.mv_rewrite}, exact {got == want}, {d}")
        return {**d, "mv_rewrite": out.stats.mv_rewrite, "docs_scanned": out.stats.num_docs_scanned}

    t0 = time.perf_counter()
    report, d = _counted(counted, lambda: mgr.refresh("lineorder_dq"))
    refresh_s = time.perf_counter() - t0
    docs = coord.tables["lineorder_dq"].segment_meta["lineorder_dq__b0"]["numDocs"]
    if report["refreshedBuckets"] != [0] or docs != cells:
        raise AssertionError(f"(l4) refresh: {report}, {docs} view rows against {cells} cells")
    # the view's metrics are DOUBLE (the JAX package's view schema): its
    # group-by takes the torch path, the kernel adding integers only
    rec = {"refresh": {**d, "s": refresh_s, "view_rows": docs}, "rewrite": rewritten(True, "fresh", 0)}
    mv_runs, src_runs = [], []
    for _ in range(SERVING_WALL_RUNS):  # in turns: the view, then the source table
        mv_runs += _wall_ms(mgr, CONFIG2, runs=1)["runs_ms"]
        src_runs += _wall_ms(broker, CONFIG2, runs=1)["runs_ms"]
    rec["walls"] = {"view_wall_ms": statistics.median(mv_runs), "view_runs_ms": mv_runs,
                    "source_wall_ms": statistics.median(src_runs), "source_runs_ms": src_runs}

    # a ninth segment: the bucket goes stale, the query falls back
    d9 = lineorder_segment(rng, SERVING_NINTH_ROWS)
    coord.add_segment("lineorder", build_segment(table.schema, dict(d9), "lineorder_ninth",
                                                 table_config=table.config))
    try:
        sums, cnts = _config2_tables(d9)
        extra = {day: (int(s), c) for day, s, c in _config2_rows(sums, cnts)}
        base = {day: (s, c) for day, s, c in want}
        want = sorted((day, base.get(day, (0, 0))[0] + extra.get(day, (0, 0))[0],
                       base.get(day, (0, 0))[1] + extra.get(day, (0, 0))[1]) for day in set(base) | set(extra))
        stale = mgr.stale_buckets("lineorder_dq")
        if stale != [0]:
            raise AssertionError(f"(l4) the view is not stale after a ninth segment: {stale}")
        rec["stale"] = rewritten(False, "stale", n + 1)
        t0 = time.perf_counter()
        mgr.refresh("lineorder_dq")
        rec["repaired"] = {**rewritten(True, "refreshed", 0), "refresh_s": time.perf_counter() - t0}
    finally:
        _drop_segment(coord, "lineorder", "lineorder_ninth")
        coord.drop_table("lineorder_dq")
    return rec


def _serving_turns(seg, cluster, batch, counted):
    """(l5): config 2 through ServerInstance.execute on (q1)'s bare server
    and on the server phase 4k registered with a coordinator (a device
    budget and a residency manager), over the same segments, in turns."""
    from pinot_tpu_torch.query.reduce import reduce_results
    from pinot_tpu_torch.sql.parser import parse_query

    want = seg["golden"]["a_config2"]
    sides = {"bare": batch["server"], "registered": cluster["direct"]}

    def run(server):
        names = server.segment_names("lineorder")
        ctx = parse_query(CONFIG2)
        res, st = server.execute(ctx, names)
        return reduce_results(ctx, res, st)

    rec = {}
    for name, server in sides.items():
        out, d = _counted(counted, lambda: run(server))
        if sorted(out.rows) != want or d["launches"] != len(cluster["segments"]):
            raise AssertionError(f"(l5) {name} server: exact {sorted(out.rows) == want}, {d}")
        rec[name] = {**d, "exact": True, "budget": server.budget is not None,
                     "residency": server.residency is not None}
    runs = {name: [] for name in sides}
    for i in range(SERVING_WALL_RUNS):  # in turns, the first side alternating: bare, registered, registered, bare
        for name in (("bare", "registered") if i % 2 == 0 else ("registered", "bare")):
            runs[name] += _wall_ms(_Call(lambda: run(sides[name])), "", runs=1)["runs_ms"]
    for name in sides:
        rec[name].update(median_ms=statistics.median(runs[name]), min_ms=min(runs[name]), max_ms=max(runs[name]),
                         runs_ms=runs[name])
    rec["registered_minus_bare_ms"] = rec["registered"]["median_ms"] - rec["bare"]["median_ms"]
    return rec


def phase_serving_path(seg, cluster, batch, seed):
    """Phase 4l: (l1)-(l5) over phase 4k's coordinator and broker, each
    counted run exact against numpy; one serving_path line an item."""
    from pinot_tpu_torch.ops import fused_scan

    t0 = time.perf_counter()
    fused_scan.reset_counters()
    counted, records, seconds = [], {}, {}
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="serving_", dir=os.path.join(REPO, "build"))
    try:
        t = time.perf_counter()
        records["l1_rest"], srv = _serving_rest(seg, cluster, counted)
        seconds["l1_rest"] = time.perf_counter() - t
        try:
            t = time.perf_counter()
            records["l2_cli"] = _serving_cli(seg, records["l1_rest"]["url"], root, rng, counted)
            seconds["l2_cli"] = time.perf_counter() - t
        finally:
            srv.stop()
        for item, fn in (("l3_minion", lambda: _serving_minion(cluster, root, rng, counted)),
                         ("l4_mview", lambda: _serving_mview(seg, cluster, rng, counted)),
                         ("l5_server_turns", lambda: _serving_turns(seg, cluster, batch, counted))):
            t = time.perf_counter()
            records[item] = fn()
            seconds[item] = time.perf_counter() - t
    finally:
        shutil.rmtree(root, ignore_errors=True)
    alive = cluster["broker"].hedge_drain()
    if alive:
        raise AssertionError(f"{alive} hedge threads outlived phase 4l")
    for item, rec in records.items():
        log("serving_path", item=item, seconds=seconds[item], **rec)
    launches = sum(c["launches"] for c in counted)
    variants, member_axis, layouts = {}, {}, {}
    for c in counted:
        for src, dst in ((c["instantiations"], variants), (c["member_axis_launches"], member_axis),
                         (c["layouts"], layouts)):
            for k, v in src.items():
                dst[k] = dst.get(k, 0) + v
    return {"launches": launches, "variants": variants, "member_axis_launches": member_axis,
            "member_axis_layouts": layouts, "records": records, "serving_s": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# phase 4m: mesh_path — the engines over a mesh of four positions of the
# card (parallel/mesh.py) on phase 4b's 2^27-row lineorder
# ---------------------------------------------------------------------------
MESH_POSITIONS = 4
MESH_TURNS = 5  # warm runs an engine, in turns with the one-position engine
MESH_REPLICATED_QUERIES = 8
MESH_AVG_SQL = ("SELECT lo_discount, AVG(lo_revenue * 0.01), COUNT(*) FROM lineorder WHERE lo_quantity < 25 "
                "GROUP BY lo_discount ORDER BY lo_discount LIMIT 20")
# float partials add in another order than one position's (and numpy's);
# the sketch phase's tolerance
MESH_AVG_RTOL = 1e-9


def mesh_positions(n: int):
    """`n` mesh positions: the cards in turn where there are several, else
    `n` positions of cuda:0; and whether the positions are distinct cards."""
    count = torch.cuda.device_count()
    return [f"cuda:{i % count}" for i in range(n)], count > 1


def _config2_golden(d):
    od = d["lo_orderdate"].astype(np.int64) - 19920101
    m = d["lo_quantity"] < 25
    s = np.bincount(od[m], weights=d["lo_revenue"][m], minlength=2406)
    c = np.bincount(od[m], minlength=2406)
    return sorted((19920101 + int(i), float(s[i]), int(c[i])) for i in np.nonzero(c)[0])


def _avg_golden(d):
    m = d["lo_quantity"] < 25
    disc = d["lo_discount"][m]
    s = np.bincount(disc, weights=d["lo_revenue"][m].astype(np.float64) * 0.01, minlength=11)
    c = np.bincount(disc, minlength=11)
    return [(int(k), float(s[k] / c[k]), int(c[k])) for k in range(11) if c[k]]


def _rel_err(got, want) -> float:
    return max(abs(g[1] - w[1]) / abs(w[1]) for g, w in zip(got, want))


def _avg_close(got, want) -> bool:
    return (len(got) == len(want) and all(g[0] == w[0] and g[2] == w[2] for g, w in zip(got, want))
            and _rel_err(got, want) <= MESH_AVG_RTOL)


def _mesh_turns(one, mesh, sql: str) -> dict:
    """Warm wall medians of the one-position engine and the mesh engine,
    in turns (one, mesh, mesh, one, ...)."""
    runs = {"one_position": [], "mesh": []}
    for i in range(MESH_TURNS):
        for name in (("one_position", "mesh") if i % 2 == 0 else ("mesh", "one_position")):
            runs[name] += _wall_ms(one if name == "one_position" else mesh, sql, runs=1)["runs_ms"]
    return {"one_position_median_ms": statistics.median(runs["one_position"]),
            "mesh_median_ms": statistics.median(runs["mesh"]), "runs_ms": runs}


def _mesh_item(counted, label, engine, sql, check, want_launches, one):
    """One counted run of `sql` (the scan counters read around it), held
    by `check(rows)` and to `want_launches` fused-scan launches; then the
    warm medians in turns with the one-position engine `one`."""
    res, d = _counted(counted, lambda: engine.query(sql))
    if not check(res.rows):
        raise AssertionError(f"mesh_path {label}: wrong rows {list(res.rows)[:4]}")
    if d["launches"] != want_launches:
        raise AssertionError(f"mesh_path {label}: {d['launches']} fused-scan launches, want {want_launches}")
    rec = {"exact": True, "launches": d["launches"], "instantiations": d["instantiations"], "rows": len(res.rows)}
    rec.update(_mesh_turns(one, engine, sql))
    return res, rec


def phase_mesh_path(dist, join):
    """Phase 4m: the engines over a mesh of MESH_POSITIONS positions (cuda:0
    repeated on one card) on phase 4b's 2^27-row table cut into 4 shards
    (StackedTable.resharded: views, no new table).  (m1) config 2 on a 1-D
    mesh at one macro-batch and at three; (m2) query (c) and a float AVG;
    (m3) config 2 on the 2x2 mesh; (m4) a ReplicatedEngine of 2 rows of 2
    positions, 8 queries round-robin; (m5) (z1) broadcast and (z2) shuffle
    through the multi-stage engine.  Each exact (the AVG within
    MESH_AVG_RTOL) against numpy and the one-position engine, its launches
    counted; warm medians in turns with the one-position engine.  Returns
    the launches, records and profiles."""
    from pinot_tpu_torch.parallel import mesh as mesh_mod
    from pinot_tpu_torch.parallel.engine import DistributedEngine, ReplicatedEngine
    from pinot_tpu_torch.parallel.stacked import StackedTable
    from pinot_tpu_torch.sql.parser import parse_query
    from pinot_tpu_torch.utils.metrics import METRICS

    t0 = time.perf_counter()
    d, one = dist["data"], dist["engines"]["one_batch"]
    positions, distinct = mesh_positions(MESH_POSITIONS)
    table4 = dist["stacked"].resharded(MESH_POSITIONS)
    want_c2, want_avg = _config2_golden(d), _avg_golden(d)
    want_c = dist["golden"]["c_min_max_groupby"]
    mesh1d = mesh_mod.Mesh(positions, (mesh_mod.SEG_AXIS,))
    mesh2d = mesh_mod.Mesh(np.asarray(positions, dtype=object).reshape(2, 2), mesh_mod.DATA_AXES)
    engines = {"1d": DistributedEngine(mesh=mesh1d),
               "1d_three": DistributedEngine(mesh=mesh1d, launch_bytes=DIST_THREE_BATCH_BYTES // MESH_POSITIONS),
               "2x2": DistributedEngine(mesh=mesh2d)}
    for e in engines.values():
        e.register_table("lineorder", table4)
    log("mesh_setup", positions=positions, distinct_cards=distinct, shards=table4.num_shards,
        docs_per_shard=table4.docs_per_shard, setup_and_golden_s=time.perf_counter() - t0)

    counted, records, profiles = [], {}, []
    one_c2 = sorted(one.query(CONFIG2).rows)
    if one_c2 != want_c2:
        raise AssertionError("the one-position engine's config 2 differs from the numpy golden")

    def c2_check(rows):
        return sorted(rows) == want_c2

    # (m1) config 2 on the 1-D mesh: one macro-batch, then three
    for label, key in (("m1_config2", "1d"), ("m1_config2_three_batches", "1d_three")):
        e = engines[key]
        nb = len(e._plan(parse_query(CONFIG2), table4).batch_offsets)
        _, rec = _mesh_item(counted, label, e, CONFIG2, c2_check, MESH_POSITIONS * nb, one)
        records[label] = {**rec, "macro_batches": nb, "launches_per_macro_batch": rec["launches"] // nb}
        profiles.append(("mesh_profile", {"engine": key, "query": label}, e, CONFIG2))
    # (m2) query (c) (MIN / MAX) and a float AVG (psum_ordered's path)
    sql_c = DIST_QUERIES["c_min_max_groupby"]
    one_c = one.query(sql_c).rows
    _, records["m2_c_min_max"] = _mesh_item(counted, "m2_c_min_max", engines["1d"], sql_c,
                                            lambda rows: list(rows) == want_c == one_c, MESH_POSITIONS, one)
    profiles.append(("mesh_profile", {"engine": "1d", "query": "m2_c_min_max"}, engines["1d"], sql_c))
    one_avg = one.query(MESH_AVG_SQL).rows
    res, rec = _mesh_item(counted, "m2_float_avg", engines["1d"], MESH_AVG_SQL,
                          lambda rows: _avg_close(list(rows), want_avg) and _avg_close(list(rows), one_avg),
                          0, one)
    records["m2_float_avg"] = {**rec, "exact": False, "within_rtol": MESH_AVG_RTOL,
                               "max_rel_err_vs_numpy": _rel_err(res.rows, want_avg),
                               "max_rel_err_vs_one_position": _rel_err(res.rows, one_avg)}
    profiles.append(("mesh_profile", {"engine": "1d", "query": "m2_float_avg"}, engines["1d"], MESH_AVG_SQL))
    # (m3) config 2 on the 2x2 mesh (capacity mode: rows shard over both axes)
    _, records["m3_config2_2x2"] = _mesh_item(counted, "m3_config2_2x2", engines["2x2"], CONFIG2, c2_check,
                                              MESH_POSITIONS, one)
    profiles.append(("mesh_profile", {"engine": "2x2", "query": "m3_config2_2x2"}, engines["2x2"], CONFIG2))
    # (m4) a ReplicatedEngine: 2 rows of 2 positions, queries round-robin
    rep = ReplicatedEngine(mesh2d)
    table2 = dist["stacked"].resharded(2)
    rep.register_table("lineorder", table2)
    got, dm = _counted(counted, lambda: [sorted(rep.query(CONFIG2).rows) for _ in range(MESH_REPLICATED_QUERIES)])
    managers = [e.residency for e in rep.engines]
    if not (all(r == want_c2 for r in got) and dm["launches"] == 2 * MESH_REPLICATED_QUERIES
            and len({id(m) for m in managers}) == 2 and all(m.snapshot()["groups"] > 0 for m in managers)):
        raise AssertionError(f"mesh_path m4: exact {[r == want_c2 for r in got]}, {dm}")
    records["m4_replicated"] = {"exact": True, "queries": MESH_REPLICATED_QUERIES, "launches": dm["launches"],
                                "instantiations": dm["instantiations"],
                                "row_positions": [e.mesh.position_ids for e in rep.engines],
                                "residency_managers": [m.name for m in managers],
                                "resident_groups": [m.snapshot()["groups"] for m in managers],
                                **_mesh_turns(one, rep, CONFIG2)}
    profiles.append(("mesh_profile", {"engine": "replicated_2x2", "query": "m4_replicated"}, rep, CONFIG2))
    # (m5) the star join through the multi-stage engine on the 1-D mesh
    jmesh = DistributedEngine(mesh=mesh1d)
    jmesh.register_table("lineorder", table4)
    jmesh.register_table("dates", StackedTable.build(_join_schemas()["dates"], join_dimensions()[0],
                                                     num_shards=MESH_POSITIONS))
    engines["join"] = jmesh
    big = join["engines"]["big"]
    for label, name in (("m5_z1_broadcast", "z1_config5"), ("m5_z2_shuffle", "z2_shuffle")):
        sql = JOIN_QUERIES[name][0]
        want = sorted(big.query(sql).rows)
        retries = METRICS.counter("mse.exchangeOverflowRetries").value
        misses = jmesh._mse().plan_misses
        _, rec = _mesh_item(counted, label, jmesh, sql, lambda rows: sorted(rows) == want, MESH_POSITIONS, big)
        records[label] = {**rec, "overflow_retries": METRICS.counter("mse.exchangeOverflowRetries").value - retries,
                          "plans_built": jmesh._mse().plan_misses - misses}
        profiles.append(("mesh_profile", {"engine": "join", "query": label}, jmesh, sql))
    launches = sum(c["launches"] for c in counted)
    variants = {}
    for c in counted:
        for k, v in c["instantiations"].items():
            variants[k] = variants.get(k, 0) + v
    log("mesh_check", exact=True, launches=launches, instantiations=variants, positions=positions,
        distinct_cards=distinct, mesh_s=time.perf_counter() - t0)
    return {"launches": launches, "variants": variants, "records": records, "profiles": profiles,
            "engines": list(engines.values()), "replicated": rep, "tables": [table4, table2],
            "mesh_s": time.perf_counter() - t0}


# ---------------------------------------------------------------------------
# phase 4n: analysis_path — the port's lint gate and model checker on the
# card's machine, and the syncs torch reports on config 2's warm path held
# against the static auditor's verdicts
ANALYSIS_QUERIES = 2  # warm config-2 queries an engine under the sync debug mode
ANALYSIS_SCHEDULES = 25  # the tier-1 test's model-check budget


def _sync_sites(fn):
    """fn() under torch.cuda.set_sync_debug_mode("warn"): its result and
    {(relpath, line): syncs} — each warning attributed to the innermost
    frame of the port (the port's call into torch that synchronized).
    Raises if the mode cannot be set or a probe sync does not warn."""
    import traceback
    import warnings

    sites, seen = {}, []

    def hook(message, category, filename, lineno, file=None, line=None):
        if "synchronizing" not in str(message):
            return
        seen.append(1)
        for fr in reversed(traceback.extract_stack()[:-1]):
            norm = fr.filename.replace(os.sep, "/")
            if "/pinot_tpu_torch/" in norm:
                rel = "pinot_tpu_torch/" + norm.rsplit("/pinot_tpu_torch/", 1)[1]
                sites[(rel, fr.lineno)] = sites.get((rel, fr.lineno), 0) + 1
                return
        sites[("<outside the port>", 0)] = sites.get(("<outside the port>", 0), 0) + 1

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        try:
            if torch.cuda.get_sync_debug_mode() != 1:
                raise AssertionError("analysis_path: the CUDA sync debug mode could not be set to warn")
            torch.ones(1, device="cuda").item()  # the probe: a sync that must warn
            if not seen:
                raise AssertionError("analysis_path: a probe .item() under the sync debug mode did not warn")
            sites.clear()
            out = fn()
            torch.cuda.synchronize()  # settle the work; its own warning is outside the port
        finally:
            torch.cuda.set_sync_debug_mode(0)
    sites.pop(("<outside the port>", 0), None)
    return out, sites


def phase_analysis_path(seg, dist, batch):
    """Phase 4n: (n1) `cli lint --json` in a subprocess (started first, run
    beside (n2) and (n3)): exit 0, no finding, a live baseline with no
    stale entry, the model-check sweep ok; (n2) `cli mc --mutations --json`
    at the tier-1 budget, every model clean and every mutation caught, one
    caught trace saved and replayed bit for bit; (n3) config 2 warm,
    ANALYSIS_QUERIES times each through phase 4's QueryEngine, phase 4b's
    DistributedEngine and phase 4j's ServerInstance.execute (trace off)
    under torch.cuda.set_sync_debug_mode("warn"): each result exact, each
    synchronizing call site of the port with its count a query, beside the
    static auditor's verdict on it (device_sync.audit_sites).  Sites the
    auditor does not see are recorded as gaps; the phase fails on an inexact
    result, a lint or model-check gate, or a sync debug mode that cannot be
    set."""
    from pinot_tpu_torch.analysis.device_sync import NOTHING, audit_sites
    from pinot_tpu_torch.query.reduce import reduce_results
    from pinot_tpu_torch.sql.parser import parse_query

    t0 = time.perf_counter()
    lint_t0 = time.perf_counter()
    lint = subprocess.Popen([sys.executable, "-m", "pinot_tpu_torch.tools.cli", "lint", "--json"], cwd=REPO,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        # (n2) the model checker over the port's five protocol classes
        mc_t0 = time.perf_counter()
        trace_path = os.path.join(tempfile.mkdtemp(prefix="chip_smoke_mc_"), "trace.json")
        rc, out, err = _cli(["mc", "--mutations", "--json", "--schedules", str(ANALYSIS_SCHEDULES),
                             "--save-trace", trace_path])
        report = json.loads(out)
        missed = [f"{p}[{m}]" for p, e in report["protocols"].items()
                  for m, r in e.get("mutations", {}).items() if not r["caught"]]
        dirty = [p for p, e in report["protocols"].items() if e["failure"] is not None]
        if rc != 0 or not report["ok"] or missed or dirty or len(report["protocols"]) != 5:
            raise AssertionError(f"analysis_path (n2): rc {rc}, missed {missed}, failing {dirty}")
        with open(trace_path) as f:
            saved = json.load(f)
        rc_r, out_r, _ = _cli(["mc", "--replay", trace_path, "--json"])
        replayed = json.loads(out_r)
        if rc_r != 0 or not replayed["identical"] or any(
                replayed["reproduced"][k] != saved["failure"][k] for k in ("kind", "detail", "step", "schedule")):
            raise AssertionError(f"analysis_path (n2): the saved trace did not replay bit for bit: {replayed}")
        shutil.rmtree(os.path.dirname(trace_path), ignore_errors=True)
        mc = {"ok": True, "schedules_a_model": ANALYSIS_SCHEDULES, "wall_s": time.perf_counter() - mc_t0,
              "protocols": {p: {"clean_schedules": e["schedulesExplored"],
                                "mutations": {m: {"caught": r["caught"], "kind": r["failure"]["kind"],
                                                  "step": r["failure"]["step"],
                                                  "schedules": r["schedulesExplored"]}
                                              for m, r in e["mutations"].items()}}
                            for p, e in sorted(report["protocols"].items())},
              "trace": f"{saved['protocol']}[{saved['mutation']}]", "replay_identical": True,
              "replay_step": replayed["reproduced"]["step"]}
        log("analysis_mc", **mc)

        # (n3) config 2 warm through three engines under the sync debug mode
        server = batch["server"]
        names = server.segment_names("lineorder")
        want_seg, want_dist = seg["golden"]["a_config2"], _config2_golden(dist["data"])

        def server_query():
            ctx = parse_query(CONFIG2)
            res, st = server.execute(ctx, names)
            return reduce_results(ctx, res, st)

        runs = {"segment_engine": (lambda: seg["engine"].query(CONFIG2), want_seg),
                "distributed_engine": (lambda: dist["engines"]["one_batch"].query(CONFIG2), want_dist),
                "server_execute": (server_query, want_seg)}
        counted, per_engine = [], {}
        for name, (run, want) in runs.items():
            run()  # warm (each engine has run config 2 in its own phase)
            results, sites = _sync_sites(lambda: _counted(
                counted, lambda: [run() for _ in range(ANALYSIS_QUERIES)])[0])
            if any(sorted(r.rows) != want for r in results):
                raise AssertionError(f"analysis_path (n3): {name}'s config 2 under the sync debug mode is not exact")
            per_engine[name] = {site: n / ANALYSIS_QUERIES for site, n in sites.items()}
        all_sites = sorted({s for by in per_engine.values() for s in by})
        verdicts = audit_sites(all_sites)
        gaps = 0
        for rel, line in all_sites:
            v = verdicts[(rel, line)]
            gaps += v["verdict"] == NOTHING
            with open(os.path.join(REPO, rel)) as f:
                text = f.read().splitlines()[line - 1].strip()
            log("analysis_path", site=f"{rel}:{line}", symbol=v["symbol"], auditor=v["verdict"], rule=v["rule"],
                syncs_a_query={e: by.get((rel, line), 0) for e, by in per_engine.items()}, code=text)
    finally:
        lint_out, lint_err = lint.communicate(timeout=600)
    lint_s = time.perf_counter() - lint_t0
    payload = json.loads(lint_out) if lint_out.strip().startswith("{") else {}
    lint_rec = {"rc": lint.returncode, "wall_s": lint_s, "count": payload.get("count"),
                "baselined": payload.get("baselined"), "stale_baseline": len(payload.get("staleBaseline", [None])),
                "model_check_ok": payload.get("modelCheck", {}).get("ok"),
                "rules_of_findings": sorted(payload.get("rules", {}))}
    log("analysis_lint", **lint_rec)
    if not (lint.returncode == 0 and payload.get("count") == 0 and (payload.get("baselined") or 0) > 0
            and payload.get("staleBaseline") == [] and payload.get("modelCheck", {}).get("ok") is True):
        raise AssertionError(f"analysis_path (n1): cli lint --json failed: {lint_rec} {lint_err[-2000:]}")
    launches = sum(c["launches"] for c in counted)
    variants = {}
    for c in counted:
        for k, v in c["instantiations"].items():
            variants[k] = variants.get(k, 0) + v
    by_verdict = {}
    for v in verdicts.values():
        by_verdict[v["verdict"]] = by_verdict.get(v["verdict"], 0) + 1
    analysis_s = time.perf_counter() - t0
    log("analysis_check", exact=True, launches=launches, instantiations=variants, sync_sites=len(all_sites),
        auditor_gaps=gaps, sites_by_verdict=by_verdict,
        syncs_a_query={e: sum(by.values()) for e, by in per_engine.items()}, phase_4n_s=analysis_s)
    return {"launches": launches, "variants": variants, "lint": lint_rec, "mc": mc, "analysis_s": analysis_s}


# ---------------------------------------------------------------------------
# phase 4o: the public surface (user scalar functions, schema JSON, the CLI,
# device_batches) on phases 4 and 4b's tables
# ---------------------------------------------------------------------------
SURFACE_CLAMP = (1000, 500_000)
SURFACE_UDF_SQL = ("SELECT lo_orderdate, SUM(CLAMPREV(lo_revenue)), COUNT(*) FROM lineorder "
                   "WHERE lo_quantity < 25 GROUP BY lo_orderdate LIMIT 2500")
SURFACE_DICT_SQL = ("SELECT WEEKDAYTAG(lo_orderdate), COUNT(*), SUM(lo_revenue) FROM lineorder "
                    "WHERE WEEKDAYTAG(lo_orderdate) <> 'd3' AND lo_quantity < 25 "
                    "GROUP BY WEEKDAYTAG(lo_orderdate) LIMIT 10")
SURFACE_CSV_ROWS = 1 << 16  # the CSV parse runs at ~270k rows/s on the card's host


def _weekday_tag(values):
    """The dict UDF of (o2): a string a day value, "d0" .. "d6"."""
    return np.array([f"d{int(v) % 7}" for v in values], dtype=object)


def _surface_goldens(datas):
    """(o1) and (o2)'s exact rows over the row sets `datas`, from per-day
    tables of the rows with lo_quantity < 25 (count, clamped and plain
    revenue sums: float64 bincount sums of integers below 2^53); (o2)'s tag
    is a function of the day, so its groups fold the day tables."""
    cnt, clamped, rev = np.zeros(2406, np.int64), np.zeros(2406), np.zeros(2406)
    for d in datas:
        m = d["lo_quantity"] < 25
        od, rm = d["lo_orderdate"][m] - 19920101, d["lo_revenue"][m]
        cnt += np.bincount(od, minlength=2406)
        clamped += np.bincount(od, weights=np.clip(rm, *SURFACE_CLAMP), minlength=2406)
        rev += np.bincount(od, weights=rm, minlength=2406)
    days = np.nonzero(cnt)[0]
    udf = sorted((19920101 + int(i), float(clamped[i]), int(cnt[i])) for i in days)
    tag = (19920101 + np.arange(2406)) % 7
    keep = tag != 3
    tc = np.bincount(tag[keep], weights=cnt[keep], minlength=7)
    ts = np.bincount(tag[keep], weights=rev[keep], minlength=7)
    dict_rows = sorted((f"d{k}", int(tc[k]), float(ts[k])) for k in range(7) if tc[k])
    return udf, dict_rows


def _staged_shapes(item):
    """A staged macro-batch (one (cols, params[, ready]) a position) as
    shapes: each column part's, each tensor param's, each int param's value."""
    return [({c: {k: tuple(t.shape) for k, t in e.items()} for c, e in pos[0].items()},
             {k: tuple(v.shape) if isinstance(v, torch.Tensor) else int(v) for k, v in pos[1].items()})
            for pos in item]


def _device_batches_check(engine, stacked):
    """(o4): device_batches over config 2's plan against what _run stages
    for the same plan (the staging recorded while the query runs)."""
    from pinot_tpu_torch.sql.parser import parse_query

    staged = {}
    real = engine._stage_batch

    def recorder(plan, stacked_, j, shared, prefetch=False):
        out = real(plan, stacked_, j, shared, prefetch)
        staged[j] = _staged_shapes(out)
        return out

    engine._stage_batch = recorder
    try:
        engine.query(CONFIG2)
    finally:
        del engine._stage_batch
    plan = engine._plan(parse_query(CONFIG2), stacked)
    batches = engine.device_batches(plan, stacked)
    torch.cuda.synchronize()
    got = [_staged_shapes(b) for b in batches]
    on_card = all(t.is_cuda for b in batches for cols, _ in b for e in cols.values() for t in e.values())
    want = [staged[j] for j in sorted(staged)]
    if len(batches) != len(plan.batch_offsets) or got != want or not on_card:
        raise AssertionError(f"surface (o4): device_batches {len(batches)} batches {got[:1]} against _run's "
                             f"{len(want)} {want[:1]} (on the card: {on_card})")
    del batches
    return {"batches": len(got), "positions": len(got[0]), "columns": got[0][0][0], "params": got[0][0][1]}


def phase_surface_path(seg, dist):
    """Phase 4o: (o1) a device UDF registered through
    register_device_function (a torch clamp of lo_revenue) in a config-2
    shaped group-by on phase 4b's DistributedEngine and phase 4's
    QueryEngine, exact against numpy, launching the fused scan; (o2) a dict
    UDF registered with string_result_fn=True in a GROUP BY and a WHERE on
    both engines, exact; (o3) `cli create-segment` from a schema file
    Schema.to_json wrote and a 2^16-row CSV, then `cli query --device
    cuda`, exact; (o4) DistributedEngine.device_batches over config 2's plan
    at one macro-batch and at three, its batches and shapes those _run
    stages.  Launches counted an item."""
    from pinot_tpu_torch.query import scalar
    from pinot_tpu_torch.spi.schema import Schema

    t0 = time.perf_counter()
    scalar.register_device_function("clampRev", lambda v: torch.clamp(v, *SURFACE_CLAMP))
    scalar.register_dict_function("weekdaytag", _weekday_tag, string_result_fn=True)
    seg_engine, dist_engines = seg["engine"], dist["engines"]
    goldens = {"segment_engine": _surface_goldens(seg["datas"]), "distributed_engine": _surface_goldens([dist["data"]])}
    golden_s = time.perf_counter() - t0
    engines = {"segment_engine": seg_engine, "distributed_engine": dist_engines["one_batch"]}
    counted, records = [], {}

    # (o1), (o2) on both engines
    for item, sql, pos in (("o1_device_udf", SURFACE_UDF_SQL, 0), ("o2_dict_udf", SURFACE_DICT_SQL, 1)):
        for name, engine in engines.items():
            t = time.perf_counter()
            res, d = _counted(counted, lambda e=engine, q=sql: e.query(q))
            wall_ms = (time.perf_counter() - t) * 1e3
            if sorted(res.rows) != goldens[name][pos]:
                raise AssertionError(f"surface ({item}) on the {name}: {sorted(res.rows)[:3]} against numpy "
                                     f"{goldens[name][pos][:3]}")
            if item == "o1_device_udf" and d["launches"] < 1:
                raise AssertionError(f"surface (o1): the registered UDF's SUM did not launch the fused scan: {d}")
            records[f"{item}/{name}"] = {**d, "exact": True, "groups": len(res.rows), "first_run_ms": wall_ms}

    # (o3) create-segment from Schema.to_json's file, then query on the card
    t3 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="chip_smoke_surface_", dir=os.path.join(REPO, "build"))
    try:
        schema = seg_engine.table("lineorder").schema
        text = schema.to_json()
        if Schema.from_json(text).to_dict() != schema.to_dict():
            raise AssertionError("surface (o3): Schema.from_json(to_json()) differs from the schema")
        d = lineorder_segment(np.random.default_rng(SURFACE_CSV_ROWS), SURFACE_CSV_ROWS)
        paths = {k: os.path.join(root, k) for k in ("schema.json", "lineorder.csv", "seg")}
        with open(paths["schema.json"], "w", encoding="utf-8") as f:
            f.write(text)
        _write_csv(paths["lineorder.csv"], d)
        t = time.perf_counter()
        rc, out, err = _cli(["create-segment", "--schema", paths["schema.json"], "--csv", paths["lineorder.csv"],
                             "--out", paths["seg"], "--name", "surface_0"])
        create_s = time.perf_counter() - t
        if rc != 0:
            raise AssertionError(f"surface (o3): create-segment rc {rc}: {err[-500:]}")
        (rc, out, err), dq = _counted(counted, lambda: _cli(
            ["query", "--segments", paths["seg"], "--sql", CONFIG2, "--device", "cuda"]))
        want = _config2_rows(*_config2_tables(d))
        if rc != 0 or _cli_rows(out) != want or dq["launches"] != 1:
            raise AssertionError(f"surface (o3): cli query rc {rc}, exact {rc == 0 and _cli_rows(out) == want}, {dq}")
        records["o3_cli"] = {**dq, "exact": True, "rows": SURFACE_CSV_ROWS, "groups": len(want),
                             "create_segment_s": create_s, "schema_json_bytes": len(text),
                             "item_s": time.perf_counter() - t3}
    finally:
        shutil.rmtree(root, ignore_errors=True)

    # (o4) device_batches against _run's staging
    for label in ("one_batch", "three_batches"):
        t4 = time.perf_counter()
        (rec, d) = _counted(counted, lambda e=dist_engines[label]: _device_batches_check(e, dist["stacked"]))
        records[f"o4_device_batches/{label}"] = {**rec, "query_launches": d["launches"],
                                                 "item_s": time.perf_counter() - t4}
    torch.cuda.empty_cache()

    launches = sum(c["launches"] for c in counted)
    variants = {}
    for c in counted:
        for k, v in c["instantiations"].items():
            variants[k] = variants.get(k, 0) + v
    for item, rec in records.items():
        log("surface_path", item=item, **rec)
    surface_s = time.perf_counter() - t0
    log("surface_check", exact=True, launches=launches, instantiations=variants,
        launches_by_item={k: r.get("launches", r.get("query_launches")) for k, r in records.items()},
        golden_s=golden_s, phase_4o_s=surface_s)
    return {"launches": launches, "variants": variants, "surface_s": surface_s}


def phase_storage(seg, dist, transform, dev) -> dict:
    t0 = time.perf_counter()
    log("storage_copy_rates", unit="GB/s", torch_threads=torch.get_num_threads(), **_copy_rates(dev))
    persist = _storage_persistence(seg, transform)
    log("storage_persistence", exact=True, **persist)
    # wall timings before the sweep's profiler session
    log("storage_default_residency_walls", **_residency_walls(dist))
    sweep = _storage_sweep(dist, dev)
    storage_s = time.perf_counter() - t0
    log("storage_check", exact=True, loaded_launches=persist["launches"], tiered_launches=sweep["launches"],
        storage_s=storage_s)
    variants = dict(persist["instantiations"])
    for k, v in sweep["variants"].items():
        variants[k] = variants.get(k, 0) + v
    return {"launches": persist["launches"] + sweep["launches"], "variants": variants, "storage_s": storage_s}



def run_profiles(tasks) -> dict:
    """Every profile the query phases asked for, after all their wall
    timings (a torch.profiler session leaves tracing set up in the process);
    one log line each, and the results by (phase, engine, query)."""
    out = {}
    for phase, labels, engine, sql in tasks:
        # two sessions for the segment main path, one for the other phases:
        # a session costs ~1 s of profiler set-up on the card's host (the
        # script's time limit)
        prof = profile_query(engine, sql, sessions=2 if phase == "main_path_profile" else 1)
        log(phase, **labels, **prof)
        out[(phase, labels.get("engine"), labels["query"])] = prof
    return out



def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--segments", type=int, default=8)
    ap.add_argument("--rows-per-segment", type=int, default=1 << 23)
    args = ap.parse_args()
    t_start = time.perf_counter()

    # 1. device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card", file=sys.stderr)
        return 2
    from pinot_tpu_torch.ops import _build

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    log("device", name=torch.cuda.get_device_name(0), nvidia_smi=smi, count=torch.cuda.device_count(),
        torch=torch.__version__, cuda=torch.version.cuda, tf32="off (matmul and cudnn)")

    # 2. build
    t0 = time.perf_counter()
    _build.load()
    log("build", library=f"build/torch_kernels/{_build.LIB_NAME}", nvcc_s=_build.last_build_seconds,
        build_and_load_s=time.perf_counter() - t0)
    _compile_report()

    # 3. kernels vs plain versions
    worst = phase_kernels(np.random.default_rng(args.seed), dev)
    worst = max(worst, phase_member_grid(args.seed + 6, dev))
    shape_worst, timings = _timed_shapes(args.seed + 1, dev)
    member_shapes = _member_shapes(args.seed + 5, dev)
    member_worst, member_timings = _timed_member_shapes(member_shapes, dev)
    worst = max(worst, shape_worst, member_worst)
    timing = timings[0]  # the distributed main path's shape
    seg_timing = timings[1]  # the segment main path's shape (the single numbers up to slice 2)

    # 4. main paths: the segment engine's, the distributed engine's, then
    # the transform path and the storage phase over the tables they built;
    # the query profiles after all their wall timings
    seg = phase_main_path(args, dev)
    dist = phase_dist_main_path(args, dev)
    transform = phase_transform_path(seg, dist)
    sketch = phase_sketch_path(seg, dist, dev, args.seed + 2)
    storage = phase_storage(seg, dist, transform, dev)
    index = phase_index_path(seg, dev, args.seed + 3)
    front = phase_front_door(seg, dist)
    join = phase_join_path(seg, dist)
    realtime = phase_realtime_path(seg, args.seed + 4)
    batch = phase_batch_path(seg, dist)
    cluster = phase_cluster_path(seg, front, batch)
    serving = phase_serving_path(seg, cluster, batch, args.seed + 7)
    mesh = phase_mesh_path(dist, join)
    analysis = phase_analysis_path(seg, dist, batch)
    surface = phase_surface_path(seg, dist)
    main_variants = dict(seg["variants"])
    for part in (dist, transform, sketch, storage, index, front, join, realtime, batch, cluster, serving, mesh,
                 analysis, surface):
        for k, v in part["variants"].items():
            main_variants[k] = main_variants.get(k, 0) + v
    sse_launches, dist_launches, transform_launches = seg["launches"], dist["launches"], transform["launches"]
    storage_launches, sketch_launches, index_launches = storage["launches"], sketch["launches"], index["launches"]
    front_launches, join_launches, realtime_launches = front["launches"], join["launches"], realtime["launches"]
    batch_launches, cluster_launches, serving_launches = batch["launches"], cluster["launches"], serving["launches"]
    mesh_launches, analysis_launches, surface_launches = mesh["launches"], analysis["launches"], surface["launches"]
    member_axis_launches, member_axis_layouts = {}, {}
    for part in (batch, cluster, serving):
        for src, dst in ((part["member_axis_launches"], member_axis_launches),
                         (part["member_axis_layouts"], member_axis_layouts)):
            for k, v in src.items():
                dst[k] = dst.get(k, 0) + v
    main_launches = (sse_launches + dist_launches + transform_launches + sketch_launches + storage_launches
                     + index_launches + front_launches + join_launches + realtime_launches + batch_launches
                     + cluster_launches + serving_launches + mesh_launches + analysis_launches + surface_launches)
    profiles = run_profiles(seg["profiles"] + dist["profiles"] + transform["profiles"] + sketch["profiles"]
                            + index["profiles"] + front["profiles"] + join["profiles"] + realtime["profiles"]
                            + batch["profiles"] + cluster["profiles"] + mesh["profiles"])
    for key, rec in transform["records"].items():
        engine, _, query = key.partition("/")
        prof = profiles.get(("transform_profile", engine, query), {})
        log("transform_path", engine=engine, query=query, **rec,
            device_busy_ms=prof.get("device_busy_ms", "not run"), device_idle_share=prof.get("device_idle_share",
                                                                                             "not run"))
    for key, rec in sketch["records"].items():
        engine, _, query = key.partition("/")
        prof = profiles.get(("sketch_profile", engine, query), {})
        log("sketch_path", engine=engine, query=query, **rec,
            device_busy_ms=prof.get("device_busy_ms", "not run"),
            device_idle_share=prof.get("device_idle_share", "not run"),
            top_device_ops=prof.get("top_device_ops", "not run"))
    for key, rec in index["records"].items():
        part, engine, query = key.split("/")
        prof = profiles.get(("index_profile", engine if part != "startree" else f"segment_engine_{engine}", query), {})
        log("index_path", table=part, engine=engine, query=query, **rec,
            device_busy_ms=prof.get("device_busy_ms", "not run"),
            device_idle_share=prof.get("device_idle_share", "not run"),
            top_device_ops=prof.get("top_device_ops", "not run"))
    for key, rec in front["records"].items():
        engine, _, query = key.partition("/")
        prof = profiles.get(("front_door_profile", engine, query), {})
        log("front_door", engine=engine, query=query, **rec,
            device_busy_ms=prof.get("device_busy_ms", "not run"),
            device_idle_share=prof.get("device_idle_share", "not run"),
            top_device_ops=prof.get("top_device_ops", "not run"))
    log("front_door_seconds", phase_4g_s=front["front_door_s"])
    for query, rec in join["records"].items():
        engine = f"dist_{JOIN_QUERIES[query][1]}"
        prof = profiles.get(("join_profile", engine, query), {})
        log("join_path", engine=engine, query=query, **rec,
            device_busy_ms=prof.get("device_busy_ms", "not run"),
            device_idle_share=prof.get("device_idle_share", "not run"),
            top_device_ops=prof.get("top_device_ops", "not run"))
    log("join_seconds", phase_4h_s=join["join_s"])
    for item, rec in realtime["records"].items():
        # r2 grew r1's consuming snapshot: one profile, taken after r2
        prof = profiles.get(("realtime_profile", "r1_hybrid" if item == "r2_freshness" else item, "config2"), {})
        log("realtime_path", item=item, exact=True, **rec,
            device_busy_ms=prof.get("device_busy_ms", "not run"),
            device_idle_share=prof.get("device_idle_share", "not run"),
            profiled_wall_ms=prof.get("profiled_wall_ms", "not run"),
            top_device_ops=prof.get("top_device_ops", "not run"))
    log("realtime_seconds", phase_4i_s=realtime["realtime_s"])
    for item, rec in batch["records"].items():
        log("batch_path", item=item, **rec)
    for query in ("q2_batch", "q2_sequential", "q4_execute_many"):
        engine = "dist" if query.startswith("q4") else "server"
        prof = profiles.get(("batch_profile", engine, query), {})
        log("batch_profile_summary", engine=engine, query=query,
            device_busy_ms=prof.get("device_busy_ms", "not run"),
            device_idle_share=prof.get("device_idle_share", "not run"),
            profiled_wall_ms=prof.get("profiled_wall_ms", "not run"),
            top_device_ops=prof.get("top_device_ops", "not run"))
    log("batch_seconds", phase_4j_s=batch["batch_s"])
    for item, rec in cluster["records"].items():
        log("cluster_path", item=item, **rec)
    prof = profiles.get(("cluster_profile", "broker", "k1_config2"), {})
    log("cluster_profile_summary", engine="broker", query="k1_config2",
        device_busy_ms=prof.get("device_busy_ms", "not run"),
        device_idle_share=prof.get("device_idle_share", "not run"),
        profiled_wall_ms=prof.get("profiled_wall_ms", "not run"),
        top_device_ops=prof.get("top_device_ops", "not run"))
    log("cluster_seconds", phase_4k_s=cluster["cluster_s"])
    log("serving_seconds", phase_4l_s=serving["serving_s"])
    for item, rec in mesh["records"].items():
        engine = next(p[1]["engine"] for p in mesh["profiles"] if p[1]["query"] == item)
        prof = profiles.get(("mesh_profile", engine, item), {})
        log("mesh_path", item=item, engine=engine, **rec,
            device_busy_ms=prof.get("device_busy_ms", "not run"),
            device_idle_share=prof.get("device_idle_share", "not run"),
            profiled_wall_ms=prof.get("profiled_wall_ms", "not run"),
            top_device_ops=prof.get("top_device_ops", "not run"))
    log("mesh_seconds", phase_4m_s=mesh["mesh_s"])
    log("analysis_seconds", phase_4n_s=analysis["analysis_s"])
    log("surface_seconds", phase_4o_s=surface["surface_s"])
    for srv in cluster["servers"]:  # the residency managers' staging threads
        if srv.residency is not None:
            srv.residency.shutdown()
    batch["engine"].residency.shutdown()
    realtime["dist_engine"].residency.shutdown()
    shutil.rmtree(realtime["root"], ignore_errors=True)
    funnel, funnel_launches = sketch["funnel"], sketch["funnel_launches"]
    dist["stacked"].release_device()
    for t in mesh["tables"]:
        t.release_device()
    for e in list(dist["engines"].values()) + [index["mv_dist"]] + list(join["engines"].values()) + mesh["engines"]:
        e.residency.shutdown()
    mesh["replicated"].shutdown()
    vector_timing = index["vector"]
    del seg, dist, transform, sketch, storage, index, front, join, realtime, batch, cluster, serving, mesh, surface
    torch.cuda.empty_cache()

    # 5. profile
    generic, flush_check = phase_kernel_profile(args.seed + 1, dev, timings)
    _member_scan_ms(member_shapes, dev, member_timings)
    del member_shapes
    member_axis_check = _member_axis_check(member_timings, timings[0])

    # 6. summary
    kernels = [{
        "name": "fused_scan",
        "route": "cuda",
        "source": "pinot_tpu_torch/ops/csrc/fused_scan.cu",
        "replaces": "pinot_tpu/ops/pallas_scan.py:146",
        "replaces_function": "fused_group_tables_pallas",
        "exact": worst == 0.0,
        "launches": main_launches,
        "launches_on_main_path": main_launches,
        "launches_by_path": {"segment_engine": sse_launches, "distributed_engine": dist_launches,
                             "transform_path": transform_launches, "sketch_path": sketch_launches,
                             "storage": storage_launches, "index_path": index_launches,
                             "front_door": front_launches, "join_path": join_launches,
                             "realtime_path": realtime_launches, "batch_path": batch_launches,
                             "cluster_path": cluster_launches, "serving_path": serving_launches,
                             "mesh_path": mesh_launches, "analysis_path": analysis_launches,
                             "surface": surface_launches},
        "member_axis_launches_on_main_path": member_axis_launches,
        "member_axis_layouts_on_main_path": member_axis_layouts,
        "max_abs_err": worst,
        "shape": timing["shape"],
        "ms": timing["kernel_ms"],
        "kernel_ms": timing["kernel_ms"],
        "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"],
        "bound_by": timing["bound_by"],
        "library_ms": timing["library_ms"],
        "scan_ms": timing["scan_ms"],
        "segment_path_shape": {k: seg_timing[k] for k in (
            "shape", "kernel_ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "scan_ms")},
        "filter_launch_shape": {k: timings[5][k] for k in (
            "shape", "kernel_ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "scan_ms")},
        "mv_explode_shape": {k: timings[6][k] for k in (
            "shape", "kernel_ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "scan_ms")},
        "in_subquery_shape": {k: timings[7][k] for k in (
            "shape", "kernel_ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "scan_ms")},
        "join_shape": {k: timings[8][k] for k in (
            "shape", "kernel_ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "scan_ms")},
        "instantiations_on_main_path": main_variants,
        "member_axis_shapes": [{k: t.get(k, "not measured") for k in (
            "shape", "members", "layout", "group", "kernel_ms", "scan_ms", "launch_ms", "flush_ms",
            "w_sequential_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")} for t in member_timings],
        "member_axis_check": member_axis_check,
        "shapes": timings,
        "specialised_vs_generic": generic,
        "flush_check": flush_check,
    }, {
        "name": "funnel_scan",
        "route": "cuda",
        "source": "pinot_tpu_torch/ops/csrc/funnel_scan.cu",
        "replaces": "pinot_tpu/query/aggs_stats.py:489",
        "replaces_function": "_ordered_funnel_reach (its lax.sort by (key, ts) and lax.scan; not a pallas_call)",
        "exact": funnel["max_abs_err"] == 0,
        "launches": funnel_launches,
        "launches_on_main_path": funnel_launches,
        "launches_by_path": {"sketch_path": funnel_launches},
        "max_abs_err": funnel["max_abs_err"],
        "shape": funnel["shape"],
        "ms": funnel["kernel_ms"],
        "kernel_ms": funnel["kernel_ms"],
        "plain_ms": funnel["plain_ms"],
        "bound_ms": funnel["bound_ms"],
        "bound_by": funnel["bound_by"],
        "library_ms": funnel["library_ms"],
        "scan_ms": funnel["scan_ms"],
        "whole_ms": funnel["whole_ms"],
        "shapes": {name: {k: v[k] for k in (
            "shape", "kernel_ms", "scan_ms", "bound_ms", "plain_ms", "prepare_ms", "whole_ms", "whole_device_ms",
            "max_abs_err")} for name, v in funnel["shapes"].items()},
        "huge_key": funnel["huge_key"],
    }]
    log("vector_similarity", **vector_timing)
    log("script", seconds=time.perf_counter() - t_start)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
