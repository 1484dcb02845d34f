#!/usr/bin/env python3
"""Chip check of the PyTorch/CUDA port (``ksql_tpu_torch``) on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py [--seed N]

Phases, in this order; any failure exits non-zero and prints no result:

1. Device and build: the card's name and power limit, then every CUDA
   kernel of the main path built from ``ksql_tpu_torch/csrc`` by its own
   ``nvcc`` (all started together), with each build's seconds and its
   ``-Xptxas -v`` report.
1f. The launch floor: an empty kernel, built the same way and called
   through ctypes, its device ms and call ms (K1's table mode, one launch
   a change on phase 19's path, stands on it).
2. Each kernel against its plain torch twin on the card, at the flagship's
   shapes (65,536-row batches, a 2^20-slot store that is 70% full with
   graves, zipf(1.3) keys): exact for every int and bool column, rtol 1e-12
   for float64 sums (atomic order is not fixed).  Per kernel: its device
   time per call from torch.profiler (``ms``), the median CUDA-event time
   of one wrapper call over 50 calls after warm-up (``call_ms``, host
   launch cost included), the twin's time, the least time the card could
   take (bytes over 3.35 TB/s, ops over 67 TOP/s) and a PyTorch library
   yardstick where one exists.  K2 also at phase 12g's 2^20-row batch,
   where its cooperative grid strides over more rows than it has threads;
   K3 also at phase 3's own timestamps (about a quarter of the rows on one
   slot), printed only.
2h. The hopping path's kernels against their twins at BASELINE #2's shapes
   (16,384-row batches, k = 4, S = 4 slices per window, a ring of 102
   slices, a 2^16-slot store 70% full with graves, stale ring cells and
   zipf(1.3) keys): K1's sliced and expansion modes, K5 sliced_fold, K7
   member_lanes, K6 combine_windows (and its plain gather at the flagship's
   shapes) and K4's sliced branch; exact for ints, bools and slots, rtol
   1e-12 for float64 sums.  Yardstick: torch.gather + sum/amin/amax over
   dim 1 for K6, none for K5 and K7.
3. End to end: ``run_plan`` on the flagship plan
   (``ksql_tpu_torch/plans/pv_counts_tumbling.json``, tumbling COUNT(*)
   GROUP BY URL) over 8 x 65,536 JSON records of 50,000 zipf(1.3) URLs.
   The sink must equal the port's own ``device="cpu"`` run record for
   record, the last count per (URL, window) must equal a dict count of the
   records, and the store must not overflow.  Prints events/s, p50/p99
   batch time and peak device memory.
4. Growth: 10 x 131,072 records over 48 h of event time, ~330,000
   (URL, window) keys, from a 2^20-slot store: the load trigger must run the
   retention pass (K4), which frees the windows past retention, and grow
   the store to 2^21 slots with zero overflow and exact counts.
6. Hopping end to end, sliced: ``run_plan`` on BASELINE #2's plan
   (``ksql_tpu_torch/plans/pv_stats_hopping.json``, SUM/AVG/MIN/MAX of
   USER_ID over HOPPING 1 h / 15 min windows GROUP BY URL) over 8 x 16,384
   JSON records of 50,000 zipf(1.3) URLs, 17 ms apart; the store is asked
   for 2^20 slots, clamped to 2^15 by the state budget, and grows.  The
   route must be sliced (ring 102, k 4), the sink must equal the port's
   ``device="cpu"`` run, the last value per (URL, window) a numpy dict
   reference, and nothing may overflow.
7. Hopping long span, sliced: 72 x 8,192 records over 48 h, 500 hot URLs
   in every hour and an hour-local pool of 2,000 URLs per hour: at least
   one retention pass (K4) must free keys, the ring must be resized, the
   store must grow, values must equal the dict reference.
2j. The stream-table join's kernels against their twins at BASELINE #3's
   shapes (65,536 rows, a 2^18-slot table of 100,000 users with 5% graves,
   stream keys uniform over 0..199,999 so about half match): K8
   probe_find, K1's table mode, and K9 table_upsert after K2 on a
   changelog batch with repeated keys, tombstones (some of absent keys)
   and delete + re-insert pairs; all exact, the dump row included.
   Yardstick: ``index_select`` per column for K8.
8. Hopping end to end on the expansion route (``sliced=False``), phase 6's
   traffic into a 2^20-slot store: the sink must equal the CPU run, and the
   final value per (URL, window) phase 6's and the dict's.
9. BASELINE #3 end to end (``ksql_tpu_torch/plans/enriched_join.json``,
   CLICKS LEFT JOIN USERS WHERE REGION <> 'excluded') through
   ``start_plan``/``run_until_quiescent``: 100,000 USERS into a 2^18-slot
   table store, 4 x 65,536 CLICKS, then 2 more batches with 4,096 USERS
   changes before the second; the sink must equal a dict join replayed
   in the executor's order, record for record, with no overflow.
9g. Table growth: the users in ticks of 4,096 into a 2^14-slot table
   store, which must double to 2^18 while they load; then one click batch
   must equal the dict join.
2s. The stream-stream join's kernels against their twins at BASELINE #4's
   shapes (a 2,048-row left batch with 5% null keys, 2% late rows and 16
   padding rows; a 16,385-entry right ring filled from bench.py's traffic,
   entries past the retention dead; a left ring whose cursor wraps): K10
   ss_match (count, write), K11 ss_insert (prologue, write) and K12
   ss_expire; all exact, dump entries included.  No single PyTorch call
   computes any of them, so there is no yardstick.
10. BASELINE #4 end to end (``ksql_tpu_torch/plans/ss_join_grace.json``,
   LEFTS LEFT JOIN RIGHTS WITHIN 10 SECONDS GRACE PERIOD 1 SECOND) through
   ``start_plan``: bench.py:610-665's traffic (20,000 keys, V = ID, a
   record every 2 ms), 16 batches of 2,048 JSON records a side,
   alternating, one a tick (``run_until_quiescent`` + ``drain``), rings of
   2^14, 8 x 2,048 match lanes, then ``flush_time``.  The sink must equal
   the port's CPU run record for record; its joined rows must equal a
   numpy count of the (L, R) pairs with equal ID within 10 s, its padded
   rows the lefts without one; no loss, no match overflow, no grow.
10g. Both growths: phase 10's first 16 batches a side with
   ``ss_buffer_capacity`` 512 (rings from 2,048 entries to at least 8,192)
   and 64 match lanes (at least two doublings); the sink must equal a run
   at phase 10's sizes.
2w. The session path's kernels against their twins at BASELINE #5's
   shapes: BASELINE #5's query run on the card over phase 11's first 8
   batches into a 2^20-slot store with 32 session slots, then batch 9 with
   5% null keys, 2% rows 9-11 min late (a 9.5 min grace drops some) and 1%
   repeated timestamps: K1's session mode, K14 prologue, K13 on the rows,
   K14 first and items (270,336 items), K13 on the items, K15
   session_merge (it reports the longest key run and the tiles of sorted
   positions it spans), K16 delete, K2 and K16 write; all exact, every
   emission lane and the dump slot included.  Yardstick: two stable
   torch.argsort calls for K13; no single PyTorch call computes K14-K16.
11. BASELINE #5 end to end (``ksql_tpu_torch/plans/pv_sessions.json``,
   COUNT(*) per URL over SESSION (30 SECONDS)) through ``run_plan`` at
   bench.py:668-692's sizes (8 batches, half its 16): 8 x 8,192 JSON records of bench.py's
   ``_pv_batches`` traffic (seed 7, zipf(1.3) over 50,000 URLs, 17 ms
   apart), a 2^20-slot store, 16 session slots.  The sink must equal the
   port's CPU run record for record, the live sessions at the end a numpy
   split of each URL's timestamps at gaps over 30 s; no overflow; the
   session slots must grow (the batch restarts on ``sess_ovf``).
11g. Both growths: phase 11's first 8 batches with 4 session slots (the
   reference's default) and a 2^14-slot store: the slots must reach 32, the
   store must grow, and the sink must equal phase 11's.
2f. The EMIT FINAL and HAVING kernels against their twins at the
   flagship's shapes (a 65,536-row batch with 2% late rows, its 65,536
   tumbling lanes and 196,608 k = 3 hopping lanes; a 2^20-slot store 70%
   full, 20% of it dirty and 5% emitted, windows whose close and horizon
   fall before, inside and after the batch's stream times): K1 without its
   grace cut, K17 suppress_clock on both lane layouts, K18 suppress_close,
   K19 having_verdict and K4's suppress mode; then K17 and K18 at the
   shapes the main paths give them: phase 12h's (16,384 rows, 15 min
   advance, 65,536 k = 4 lanes) and phase 12g's (2^20 rows, tumbling); all
   exact, K18 one kernel record a call at each shape.  K17's yardstick:
   two torch.cummax calls over the masked lanes and rows (the running
   maxima alone); no single PyTorch call computes the others.
12. BASELINE #1 with EMIT FINAL (``ksql_tpu_torch/plans/pv_counts_final.json``,
   no grace) through ``run_plan`` over phase 3's traffic at 16 batches, then
   ``flush_time(last ts + 1 h)``: the sink must equal a numpy model of the
   reference's rule (a window emits in the batch whose stream times first
   reach its close if one of them is within its horizon, is evicted
   unemitted otherwise, and the flush emits the windows still open), each
   window once, by window start then first touch.  Prints events/s and
   the p50/p99 of the batches that close windows and of those that do not,
   and the run's breakdown (12b: the plan is never pipelined, so the
   breakdown's synchronized device steps change no overlap).
12g. EMIT FINAL growth: phase 4's 48 h traffic shape in 1,310,720 records
   (a 2^20-row batch, then a quarter batch) from a 2^20-slot store: K4's
   suppress mode, a compaction and a grow to 2^21 that carries ``born``
   and ``emitted``; the sink must equal the numpy model.
12h. BASELINE #2 with EMIT FINAL (``pv_stats_hopping_final.json``) over
   phase 8's traffic on the expansion route (the reference's reason),
   then a flush: the sink must equal the port's CPU run, each window once.
13. ksqlDB's possible_fraud query (``possible_fraud.json``, HAVING
   COUNT(*) > 3 per URL and minute) over phase 3's first 4 batches with USER_ID
   drawn as bench.py does: the sink must equal a numpy count, no
   tombstone.
13r. A HAVING verdict that flips both ways (``pv_having_retract.json``,
   AVG(USER_ID) > 500) on the first 4 batches of the same traffic:
   retraction tombstones, and the sink equal to the port's CPU run over
   the same batches.
2v. The vector aggregates' kernels against their twins at phase 14's
   shapes (a 4,096-row batch of its traffic into a 2^16-slot pv_vectors
   store half full: collect lists below, at and past their 1,000 cap, sets
   of distinct ids, LATEST_BY_OFFSET(n)'s ring mid-wrap, sorted top-3s,
   a populated dump row; 2% of the rows overflowed, 1% inactive): K20
   ``vec_collect`` (append, set, ring), K21 ``vec_topk`` (plain,
   distinct; at the batch and at ``TOPK_SKEWS``' others: none at the dump
   slot or the sentinel, the hottest slot a quarter, every row alone; and
   over DOUBLE with -0.0, +0.0, NaN and -inf), K6's wide gather of the
   winners' width-K rows, K13 on the first-occurrence order and K4's
   tumbling reset of width-K rows (a quarter of the filled slots expire,
   timed); then K20's hist mode and K22 ``vec_hist``
   on a 2^15-slot pv_user_pages store (up to 300 URLs a map, some at the
   1,000 cap).  All exact, the dump row included.  Yardstick:
   ``index_select`` of the K-wide rows for K6, two stable torch.argsort
   for K13; no single PyTorch call computes K20-K22.
14. Vector aggregates end to end (``ksql_tpu_torch/plans/pv_vectors.json``:
   COLLECT_LIST, COLLECT_SET, TOPK, TOPKDISTINCT, EARLIEST_BY_OFFSET(n)
   and LATEST_BY_OFFSET(n) of USER_ID per URL and hour) through
   ``run_plan`` over phase 6's traffic in 8 batches of 4,096 (larger
   batches overflow the store that the 256 MiB state budget clamps to
   8,192 slots before the first sampled load check): the sink must equal
   the port's CPU run record for record, the last value per (URL, hour) a
   dict model (the first 1,000 ids, the first 1,000 distinct, the 3
   largest with and without repeats, the first and last 3), the store
   must grow and not overflow.
14h. ``pv_user_pages.json`` (HISTOGRAM(URL) per USER_ID and hour) over the
   same traffic: the sink must equal the CPU run, the last map per
   (USER_ID, hour) a count of its URLs.
14b. Phase 14's first 8 batches re-run under the breakdown's timers.
2t. The table aggregation's kernels against their twins at its shapes: K8's
   find mode (65,536 rows over 2^17 slots 70% full, 5% graves, about half
   found); K23 ``vec_remove`` on 4,096 undo rows into phase 16's store at
   2^15 slots (COLLECT_LIST(ID) lists below, at and past their 1,000 cap,
   ids repeated in a list and in the batch, a populated dump row, 2%
   missed rows) and over a side store of DOUBLE lists with -0.0, +0.0 and
   NaN; K20's hist mode and K22 with the undo side's negative heads on the
   same store's HISTOGRAM(STATUS); K3 on phase 15's negated contributions
   (65,536 rows into 50 region slots).  All exact but K3's float sums
   (rtol 1e-12).  No single PyTorch call computes K8's walk, K20, K22 or
   K23; K3's yardstick is ``index_add_`` per component.
15. ``users_by_region.json`` (COUNT, SUM, AVG, STDDEV_SAMPLE of AMT per
   REGION over the USERS table) through the runner: 100,000 users over 50
   regions (BASELINE #3's users and regions), run to the end, then 4 x
   65,536 changes (70% new AMT in the same region, 20% a move, 10%
   deletes, re-inserts), in 65,536-change batches (p50/p99 over these):
   the sink must equal the CPU run, the last C/S/A/SD per region numpy
   over the final table; no overflow.
16. ``customer_orders.json`` (COUNT, SUM(AMOUNT), COLLECT_LIST(ID),
   HISTOGRAM(STATUS) per CUSTOMER_ID, WHERE STATUS <> 'CANCELLED') over 8
   x 4,096 changes of zipf customers' orders (new, NEW -> SHIPPED ->
   DELIVERED, some CANCELLED, deletes; 2% of the changes change again an
   order already changed in the batch): the sink must equal the CPU run,
   the last value per customer a Python model of the reference's batch
   rule, and N/TOTAL the final table, BY_STATUS (and ORDER_IDS below the
   cap) too where no order changed twice in a batch; some second change
   must leave the batch rule's phantom; the clamped store must grow, no
   overflow.
17. ``big_spenders.json`` (a table transform: the USERS with AMT > 500)
   over phase 15's load and its first 2 update batches, the load apart as
   there: the sink must equal
   the CPU run and the per-change rule (a passing new row emits, a
   failing or deleted one whose old row passed emits a tombstone), the
   last rows AMT > 500 over the final table.
15b. Phase 15's load, then 2 of its update batches under the breakdown's
   timers (JSON, encode, undo side, apply side, emit decode, produce, the
   card's busy share).
2x. The table-table and foreign-key joins' kernels against their twins at
   their full shapes: K8's gather mode and K9's side mode on 65,536 user
   changes (a tenth on one hot id, 10% deletes, 1% padding) into a
   2^18-slot user_accounts store holding 100,000 keys on each side (5%
   of each side deleted); K8's live mode on 65,536 foreign keys
   (5% null) against a 2^18-slot customers store (10% deleted, 5%
   graves); K24 ``fk_fanout`` over a 2^18-slot orders store of 100,000
   orders whose customers are zipf(1.3) over 10,000, for the hottest
   customer and for one with no order (the dump row holds the hottest,
   never live); K2 at phase 19's shapes, one order key and 1,024, into a
   2^16-slot orders store of 16,384 orders with 5% graves and a full
   probe chain (one key at a time too: the chain's own, which overflows,
   a stored key, a grave's and one whose base lies in the chain); then at
   phase 19's own shapes, one change a step: K1's table mode on one
   customer key, K8's live mode on one foreign key and K9's side mode on
   one change into a 2^16-slot customers store of 2,500, and K24 for the
   hottest customer of 4,096 orders in a 2^16-slot store.  All exact.
   Yardsticks: ``index_select`` per column for K8's gather, ``nonzero`` +
   ``index_select`` for K24; no single PyTorch call computes K8's walk, K9
   or K2.
18. ``user_accounts.json`` (USERS LEFT JOIN ACCOUNTS on the key) through
   ``start_plan``: BASELINE #3's 100,000 users and 90,000 accounts loaded
   apart, then 4 single-sided batches of 65,536 changes (users and
   accounts in turn; 70% updates, 20% deletes, 10% re-inserts) into a
   2^18-slot store (p50/p99 over these): the sink must equal a dict model
   of the join change for change, no overflow, no grow.
18b. Two more update batches on the same handle under the breakdown's
   timers; the sink against the model again.
18g. The same plan from a 2^14-slot store, 8 ticks of 4,096 changes
   (users, then their accounts): the store must grow at least twice
   (host rebuilds), the sink equal the dict model, no overflow.
19. ``orders_enriched.json`` (ORDERS LEFT JOIN USERS on the order's
   CUSTOMER_ID) one change a step (the reference refuses a batched
   foreign-key join) into 2^16-slot stores: 2,500 users and 4,096 orders
   (zipf(1.3) customers; both counts are cut by the per-record rule),
   then 512 user changes (90% renames, 10% deletes; customers uniform,
   the first the hottest, so each fans out through K24) and 512 order
   changes (50% a new customer, 25% a new amount, 25% deletes): the sink
   must equal a dict model change for change, no overflow.
2p. K25 ``tap_residual`` against its twin, exact, over PAGE_VIEWS-shaped
   columns (bench.py:119-146's traffic: zipf(1.3) URLs over 50,000,
   USER_ID 0..999, 17 ms apart, 5% NULLs in each column, 2% null rows,
   3% inactive lanes, partial LIMIT budgets): the ``USER_ID % N = i``
   family at 256 lanes x 4,096 rows (bench_push_fanout's widest tap count,
   the registry's poll size) and at 4,096 lanes x 8,192 rows (the fused
   capacity's and the ring's maxima), both timed; then the corpus
   families (``URL = k AND VIEWTIME >= t``, ranges, NOT, IS NULL OR,
   ``<>``, [NOT] BETWEEN, [NOT] IN, a division by a column with zeros, and
   the CAST and CASE families: a double truncated to INT, a BIGINT to
   DECIMAL(4, 1), a TIMESTAMP floored to its DATE; searched CASE with and
   without ELSE over mixed numeric results) at 64 lanes x 4,096 rows each;
   one kernel record a call where timed.  No single PyTorch call computes
   it: no yardstick.
20. Standalone fan-out, BASELINE config 8 (bench.py:881-1020) at its full
   size: one shared pipeline over PAGE_VIEWS (the identity plan per record,
   ``capacity=1``) through ``start_push_registry``; 256 ``USER_ID % 256 = i``
   taps, 16 ``URL = '/page/k' AND VIEWTIME >= t`` taps, 4 LIMIT 100 taps and
   one LIKE tap (host); 10,000 events produced 1,024 a round, every session
   polled after each round.  Every session's rows must equal a numpy model
   of its filter and projection and the port's ``device="cpu"`` run; every
   fused tap's spans must come from K25, none from the host path.  Prints
   delivered rows/s, p50/p99 poll-round ms and the K25 launches.
21. Listener fan-out: PV_STREAM (``pv_stream.json``) run by ``start_plan``
   at capacity 4,096 and registered as the upstream; phase 20's taps over
   PV_STREAM; 16 rounds of 4,096 records.  Every span must come from the
   upstream's device emit blocks; the same model and CPU-run checks, the
   same numbers.
2a. The offsets' argset modes against their twins, exact by their bits
   (every component, the dump slot included): K3's argset mode at the
   flagship's shapes (65,536 rows after K3's fold into a 2^20-slot store
   70% full with graves; EARLIEST over a DOUBLE and LATEST(x, false) over a
   BIGINT; 3% inactive rows and 1% overflowed rows aimed at the dump, a
   tenth of the held slots never a candidate, NULLs ignored and kept,
   -0.0, +0.0, NaN and inf payloads); K15's argset mode at phase 2w's
   shapes (8,192 rows and 32 session slots: 270,336 items in K14's
   layout, the same components; once more, untimed, with the orders
   modulo 50, so tied winners' payloads are summed; the longest key run
   and its tiles reported).  Yardstick for K3: ``index_put_`` of the
   payloads, whose duplicate-index order is unspecified, so it cannot keep
   the dump rule; none for K15.
22. ksqlDB's quickstart view (``current_location.json``: LATEST_BY_OFFSET of
   LATITUDE and LONGITUDE per PROFILEID) over 8 x 65,536 JSON records of
   300,000 uniform profile ids with 2% NULL latitudes into a 2^20-slot
   store: the sink must equal the CPU run record for record, the last
   LA/LO per profile the last non-NULL value in arrival order (numpy), no
   overflow.  Prints events/s, p50/p99 batch time, peak device memory.
23. ``pv_offsets.json`` (EARLIEST_BY_OFFSET(USER_ID),
   LATEST_BY_OFFSET(CAST(USER_ID AS DOUBLE) * 0.1, false), SUM(CASE ...),
   MAX(ABS(USER_ID - 500)), SUM(CAST(USER_ID AS DECIMAL(10, 2))) per URL
   and hour) over the flagship's 8 x 65,536 records with 2% NULL
   USER_IDs: the sink must equal the CPU run, every final value per (URL,
   hour) a numpy model, the DECIMAL sums exactly; no overflow.
23h. Its HOPPING 1 h / 15 min variant over phase 8's 8 x 16,384 on the
   expansion route (it prints the reference's reason), the same checks
   per (URL, window).
23s. Its SESSION (30 s) variant over 4 x 8,192 records (phase 11's batch,
   half its 8 batches), 16 session slots: the same checks over each live
   session (a numpy split of each URL's timestamps at 30 s gaps).
5. Launch counters, per path: the counts (per kernel, and per mode for K1,
   K3, K4, K6, K8, K9, K10, K11, K14, K15, K16, K17, K20 and K21) are set to 0 just before each of
   phases 3, 4, 6, 7, 8, 9, 9g, 10, 10g, 11, 11g, 12, 12g, 12h, 13, 13r, 14,
   14h, 15, 16, 17, 18, 18g, 19, 20, 21, 22, 23, 23h and 23s drives the runner on the card (and, for 12-12h, its flush) and read
   just after it; each phase must have launched every kernel of its route
   in the route's modes (``PATH_KERNELS``), and no kernel or mode outside
   it.  Then short profiled re-runs split a batch's time into
   host stages and the card's busy share, for the flagship (3b), BASELINE
   #2 (6b), BASELINE #3 (9b), BASELINE #4 (10b), BASELINE #5 (11b, with
   the share of its one ``sess_ovf`` read) and pv_vectors (14b); phase 12
   carries its own (12b).

The last line is ``{"ok": true, "device": {...}}``; the line before it holds
the per-kernel JSON record, and the line before that the card's name and
power limit as ``nvidia-smi`` reports them.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
INT_OPS_PER_S = 67e12  # H100 SXM float32 rate outside the tensor cores (NVIDIA data sheet)
N_ROWS = 1 << 16
STORE = 1 << 20
N_BATCHES = 16
#: phase 3's depth, cut from 16 for the script's time (PERF.md §4)
FLAGSHIP_BATCHES = 8
N_URLS = 50_000
GROWTH_ROWS = 1 << 17
#: phase 4: 10 batches, each URL of an hour's pool seen 4 times (cut from
#: 20 batches and 8 views for the script's time: the same ~330,000 keys)
GROWTH_BATCHES = 10
GROWTH_REPEATS = 4
HOP_ROWS = 1 << 14  # BASELINE #2's batch: CAPACITY // 4 (bench.py:217)
HOP_STORE = 1 << 16
HOP_RING = 102  # (1 h + 24 h grace) / 15 min + 2
DEVICE = "cuda"
TS0 = 1_700_000_000_000
HOUR_MS = 3_600_000
REPS = 50
#: calls a twin is timed over (its median; cut from 50 for the script's time)
PLAIN_REPS = 10
#: batches of the breakdown re-runs 3b, 6b, 9b, 10b and 11b (cut from 4 for the script's time)
BREAKDOWN_BATCHES = 2


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def require(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


# ------------------------------------------------------------------ timing
def time_events(torch, fn, reset=None, reps=REPS, warmup=3) -> float:
    """Median ms of ``fn()`` between CUDA events; ``reset()`` runs before
    each launch, outside the timed span (in-place kernels start from the
    same state every time)."""
    for _ in range(warmup):
        if reset is not None:
            reset()
        fn()
    times = []
    for _ in range(reps):
        if reset is not None:
            reset()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return float(np.median(times))


#: CUDA function names of each kernel wrapper's launches
KERNEL_FUNCS = {
    "row_prologue": ("row_prologue_kernel", "batch_max_kernel"),
    "probe_insert": ("block_kernel", "grid_kernel"),
    "fold_and_mark": ("fold_mark_kernel", "argset_kernel"),
    "evict": ("evict_kernel", "evict_rows_kernel"),
    "sliced_fold": ("sliced_fold_kernel",),
    "combine_windows": ("combine_kernel",),
    "member_lanes": ("lane_claim_kernel", "lane_winner_kernel"),
    "probe_find": ("probe_find_kernel", "find_slots_kernel", "gather_kernel"),
    "table_upsert": ("upsert_block_kernel", "upsert_grid_kernel"),
    "ss_match": ("tile_count_kernel", "tile_write_kernel"),
    "ss_insert": ("insert_prologue_kernel", "insert_write_kernel"),
    "ss_expire": ("expire_kernel",),
    "seg_sort": ("block_sort_kernel", "merge_pass_kernel"),
    "session_items": ("prologue_kernel", "first_kernel", "items_kernel"),
    "session_merge": ("permute_kernel", "merge_kernel"),
    "session_write": ("delete_kernel", "write_kernel"),
    "suppress_clock": ("clock_kernel",),
    "suppress_close": ("close_slots_kernel",),
    "having_verdict": ("verdict_kernel", "dump_kernel"),
    "vec_collect": ("collect_keys_kernel", "collect_member_kernel", "collect_place_kernel"),
    "vec_topk": ("topk_kernel",),
    "vec_hist": ("hist_count_kernel",),
    "vec_remove": ("remove_kernel",),
    "fk_fanout": ("fanout_kernel",),
    "tap_residual": ("tap_tile_kernel",),
}


def _device_us(evt) -> float:
    for attr in ("device_time_total", "cuda_time_total"):
        v = getattr(evt, attr, None)
        if v:
            return float(v)
    return 0.0


#: the spin kernels (torch's ``_sleep``, in GPU cycles) a profiled region
#: opens and closes with: the profiler can drop device records near
#: either end of a trace's window (seen on the H100 for most of a trace's
#: calls), so the timed calls run between a ~50 ms spin and two ~2 ms ones
_LEAD_CYCLES = 100_000_000
_FENCE_CYCLES = 4_000_000
_FENCES = 2


def _profiled_records(torch, fn, reset, reps, pats):
    """One torch.profiler trace of ``reps`` calls of ``fn`` between fences
    (a long spin kernel before them; two short ones and an event recorded
    and synchronized after them): ``(the records of the kernel's
    functions, their device us, whether the closing fence's records came
    back)``."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(_LEAD_CYCLES)
        for _ in range(reps):
            if reset is not None:
                reset()
            fn()
        for _ in range(_FENCES):
            torch.cuda._sleep(_FENCE_CYCLES)
        fence = torch.cuda.Event()
        fence.record()
        fence.synchronize()
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    mine = [e for e in events if any(p.search(e.name) for p in pats)]
    spins = sorted((e for e in events if "spin_kernel" in e.name), key=lambda e: e.time_range.start)
    # the closing fence: the two spins after the last of the timed calls
    last = max((e.time_range.start for e in mine), default=-1)
    fenced = sum(e.time_range.start > last for e in spins) == _FENCES
    return len(mine), sum(e.time_range.elapsed_us() for e in mine), fenced


def kernel_device_ms(torch, name, fn, reset=None, reps=REPS, per_call=None) -> float:
    """Mean device time (ms) of kernel ``name``'s CUDA functions per call of
    ``fn``, from torch.profiler over ``reps`` calls (the copies that
    ``reset`` launches are not counted).  The trace must hold exactly
    ``reps * per_call`` records of those functions and the fence after
    them (``per_call`` None: the records one fenced call makes); a short
    trace is taken again, three times in all, and one that stays short
    fails the phase."""
    for _ in range(3):
        if reset is not None:
            reset()
        fn()
    torch.cuda.synchronize()
    # a function name not preceded by a letter or "_" (slice_fold_kernel is
    # not fold_kernel), demangled or not
    pats = [re.compile(rf"(?<![A-Za-z_]){f}") for f in KERNEL_FUNCS[name]]
    # a trace can come back without some of its kernels' records: the
    # fences and the count show it, and only a whole trace is kept
    for attempt in range(1, 4):
        records = per_call
        if records is None:
            records, _us, fenced = _profiled_records(torch, fn, reset, 1, pats)
            if not fenced or records == 0:
                print(f"[profile] {name}: calibration trace {attempt} of 3 came back short")
                continue
        count, total, fenced = _profiled_records(torch, fn, reset, reps, pats)
        if fenced and count == reps * records:
            return total / reps / 1e3
        print(f"[profile] {name}: trace {attempt} of 3 held {count} of {reps} x {records} kernel "
              f"records (fence {'in' if fenced else 'missing'})")
    require(False, f"{name}: three profiler traces came back short")


def bound(bytes_moved: float, ops: float):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ------------------------------------------------------------- phase 1
def phase_device_and_build(torch):
    from ksql_tpu_torch.ops import cuda

    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[1] device: {name} (torch {torch.__version__}, CUDA {torch.version.cuda})")
    print(f"[1] nvidia-smi: {smi}")
    t0 = time.perf_counter()
    builds = cuda.build()
    print(f"[1] built {len(builds)} kernels in {time.perf_counter() - t0:.2f} s (parallel nvcc)")
    for k, info in builds.items():
        print(f"[1] {k}: nvcc {info['seconds']:.2f} s")
        for line in info["ptxas"].splitlines():
            if "ptxas" in line and ("registers" in line or "Compiling" in line or "spill" in line):
                print(f"      {line.strip()}")
    return name, smi


#: an empty kernel, built as the port's kernels are: the launch floor
EMPTY_KERNEL = """extern "C" __global__ void empty_kernel() {}
extern "C" int ksql_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
"""


def phase_launch_floor(torch):
    """Phase 1f: an empty kernel's device ms (profiler) and call ms (CUDA
    events, through ctypes as every kernel of the port is called): the
    floor under a kernel launched once a change, as K1's table mode is on
    phase 19's path."""
    import ctypes

    from ksql_tpu_torch.ops import cuda

    out = cuda.BUILD_DIR / "launch_floor"
    out.mkdir(parents=True, exist_ok=True)
    (out / "empty.cu").write_text(EMPTY_KERNEL)
    subprocess.run([cuda.nvcc_path(), *cuda.NVCC_FLAGS, "-o", str(out / "libempty.so"),
                    str(out / "empty.cu")], check=True, capture_output=True)
    fn = ctypes.CDLL(str(out / "libempty.so")).ksql_empty
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    stream = torch.cuda.current_stream().cuda_stream
    KERNEL_FUNCS["empty"] = ("empty_kernel",)

    def call():
        cuda.check("empty", fn(stream))

    ms = kernel_device_ms(torch, "empty", call)
    call_ms = time_events(torch, call)
    print(f"[1f] launch floor: an empty kernel (1 block of 32 threads) device {ms:.4f} ms, call "
          f"{call_ms:.4f} ms")
    return {"ms": ms, "call_ms": call_ms}


# ------------------------------------------------------------- phase 2
def _urls(n):
    return np.array([f"/page/{i}" for i in range(n)], dtype=object)


def fill_store(hs, occ, kh, ws, capacity, khash, wstart):
    """Linear-probing insert of distinct keys with no probe limit (the
    host rebuild stops at 128 probes, which a 70%-full table exceeds):
    each round the lowest row wins each free candidate, and every other
    row moves one slot on."""
    mask = capacity - 1
    wmul = (wstart.astype(np.int64).view(np.uint64) * np.uint64(0x9E3779B97F4A7C15)).view(np.int64)
    cand = (hs.np_mix64(khash ^ wmul) & mask).astype(np.int64)
    slots = np.empty(len(khash), np.int64)
    todo = np.arange(len(khash))
    while todo.size:
        c = cand[todo]
        free = np.nonzero(~occ[c])[0]
        won_slots, first = np.unique(c[free], return_index=True)
        winners = todo[free[first]]
        occ[won_slots] = True
        kh[won_slots] = khash[winners]
        ws[won_slots] = wstart[winners]
        slots[winners] = won_slots
        keep = np.ones(todo.size, bool)
        keep[free[first]] = False
        todo = todo[keep]
        cand[todo] = (cand[todo] + 1) & mask
    return slots


def make_store(torch, hs, capacity, n_keys_fill, rng, url_hashes, device):
    """A store that is ``n_keys_fill / capacity`` full of (URL, window)
    keys, 5% of them graves, built with the host rebuild path."""
    from ksql_tpu_torch.state import state_from_numpy, state_to_numpy

    layout = hs.StoreLayout(capacity, 1, (
        hs.AggComponent("max", "int64", np.iinfo(np.int64).min),
        hs.AggComponent("add", "int64", 0),
    ), windowed=True)
    store = state_to_numpy(hs.init_store(layout, "cpu"))
    n_win = -(-n_keys_fill // len(url_hashes))
    uid = np.arange(n_keys_fill) % len(url_hashes)
    win = np.arange(n_keys_fill) // len(url_hashes)
    wstart = TS0 - (n_win - 1 - win) * HOUR_MS - (TS0 % HOUR_MS)
    reprs = url_hashes[uid]
    khash = hs.combine_hash([torch.from_numpy(reprs), torch.zeros(len(reprs), dtype=torch.int64)]).numpy()
    slots = fill_store(hs, store["occ"], store["khash"], store["wstart"], capacity, khash, wstart)
    store["key0"][slots] = reprs
    store["a0"][slots] = wstart + rng.integers(0, HOUR_MS, len(slots))
    store["a1"][slots] = rng.integers(1, 1000, len(slots))
    graves = slots[rng.random(len(slots)) < 0.05]
    store["occ"][graves] = False
    store["grave"][graves] = True
    store["a0"][graves] = np.iinfo(np.int64).min
    store["a1"][graves] = 0
    store["max_ts"] = np.array(TS0 + HOUR_MS // 2, np.int64)
    return layout, state_from_numpy(store, device)


def _clone(d):
    return {k: v.clone() for k, v in d.items()}


def _restore(dst, src):
    for k, v in src.items():
        dst[k].copy_(v)


def _assert_equal(torch, name, a, b, rtol=0.0):
    """Exact (or rtol, NaN-equal) comparison; returns the max abs error."""
    a = a.detach().cpu()
    b = b.detach().cpu()
    require(a.dtype == b.dtype and a.shape == b.shape, f"{name}: {a.dtype}{list(a.shape)} vs {b.dtype}{list(b.shape)}")
    if a.is_floating_point():
        ok = torch.isclose(a, b, rtol=rtol, atol=0.0, equal_nan=True)
        require(bool(ok.all()), f"{name}: {int((~ok).sum())} cells differ beyond rtol {rtol}")
        fin = torch.isfinite(a) & torch.isfinite(b)
        return float((a[fin] - b[fin]).abs().max()) if bool(fin.any()) else 0.0
    eq = a == b
    require(bool(eq.all()), f"{name}: {int((~eq).sum())} cells differ")
    return 0.0


def measure(torch, name, fn, plain, bytes_moved, ops, reset=None, library=None, plain_reps=PLAIN_REPS,
            per_call=None):
    """One kernel record: device ms (profiler; ``per_call`` the kernel
    records one call of ``fn`` makes, None: counted from a fenced call),
    call ms (CUDA events), the twin's ms, the bound and the library
    yardstick's ms (or None)."""
    ms = kernel_device_ms(torch, name, fn, reset, per_call=per_call)
    call = time_events(torch, fn, reset)
    plain_ms = time_events(torch, plain, reset, reps=plain_reps, warmup=1)
    lib = time_events(torch, library, reset) if library is not None else None
    b, by = bound(bytes_moved, ops)
    return dict(ms=ms, call_ms=call, plain_ms=plain_ms, bound_ms=b, bound_by=by, library_ms=lib)


def _report(phase, tag, rec):
    lib = "none" if rec["library_ms"] is None else f"{rec['library_ms']:.4f} ms"
    print(f"[{phase}] {tag}: exact (floats rtol 1e-12); device {rec['ms']:.4f} ms, call {rec['call_ms']:.4f} ms, plain "
          f"{rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.5f} ms ({rec['bound_by']}), "
          f"yardstick {lib}; max abs err {rec['max_abs_err']:.3g}")


def make_fold_case(torch, hs, rng, dev, traffic="phase2", n=N_ROWS, capacity=STORE):
    """K3's fold case at the flagship's shapes without K1 and K2: ``n``
    rows of (URL, hour) keys on distinct slots of a ``capacity``-slot
    store, the flagship's components (the window's max timestamp and
    COUNT), 0.1% of the rows inactive (at the dump slot, identity
    contributions).  ``traffic``: ``phase2``, phase 2's zipf(1.3) URLs
    over 31 hours (the hottest slot takes ~0.8% of the rows);
    ``flagship``, phase 3's, 17 ms apart (one or two windows: the hottest
    slot takes about a quarter); ``uniform``, phase 2's hours over uniform
    URLs.  Returns (store, scratch, layout, slots, contribs, active)."""
    layout = hs.StoreLayout(capacity, 1, (
        hs.AggComponent("max", "int64", np.iinfo(np.int64).min),
        hs.AggComponent("add", "int64", 0),
    ), windowed=True)
    if traffic == "uniform":
        uid = rng.integers(0, N_URLS, n)
    else:
        uid = rng.zipf(1.3, n).astype(np.int64) % N_URLS
    if traffic == "flagship":
        ts = TS0 + np.arange(n, dtype=np.int64) * 17
    else:
        ts = TS0 - 30 * HOUR_MS + np.sort(rng.integers(0, 31 * HOUR_MS, n))
    keys, inv = np.unique(uid * 64 + ts // HOUR_MS % 64, return_inverse=True)
    slots = rng.choice(capacity, keys.size, replace=False)[inv].astype(np.int32)
    active = rng.random(n) > 0.001
    slots[~active] = capacity
    store = hs.init_store(layout, dev)
    scratch = hs.init_scratch(capacity, dev)
    act = torch.from_numpy(active).to(dev)
    c0 = torch.from_numpy(np.where(active, ts, np.iinfo(np.int64).min)).to(dev)
    return store, scratch, layout, torch.from_numpy(slots).to(dev), [c0, act.to(torch.int64)], act


def fold_bytes(torch, slots, active, contribs):
    """K3 fold's bytes: per row its slot, its mask and its contributions
    read once; per touched slot each component read and written, its
    ``dirty`` flag and ``first`` cell written; the winners written."""
    n = slots.shape[0]
    touched = int(torch.unique(slots[active]).numel())
    cb = sum(c.element_size() for c in contribs)
    return n * (4 + 1 + cb) + touched * (2 * cb + 1 + 4) + n


def phase_kernels(torch, seed, n=N_ROWS, capacity=STORE):
    """Every kernel against its plain twin on the card; returns the
    per-kernel records (without launch counts)."""
    from ksql_tpu_torch.common.batch import stable_hash64
    from ksql_tpu_torch.ops import hash_store as hs

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(seed)
    url_hashes = np.fromiter((stable_hash64(u) for u in _urls(N_URLS)), np.int64, N_URLS)
    recs = {}

    # ---- K1 row_prologue: flagship key (URL), tumbling 1 h, 24 h grace
    uid = rng.zipf(1.3, n).astype(np.int64) % N_URLS
    reprs = torch.from_numpy(url_hashes[uid].reshape(1, n)).to(dev)
    valid = torch.from_numpy((rng.random((1, n)) > 0.01)).to(dev)
    ts_np = TS0 - 30 * HOUR_MS + np.sort(rng.integers(0, 31 * HOUR_MS, n))
    # rows in the window that ends exactly at the grace cut (dropped), one
    # millisecond either side of it, and a negative timestamp (floor)
    cut = TS0 - TS0 % HOUR_MS - 24 * HOUR_MS
    ts_np[:5] = [cut - HOUR_MS, cut - 1, cut, cut + 1, -1]
    ts = torch.from_numpy(ts_np).to(dev)
    active = torch.from_numpy(np.arange(n) < n - 17).to(dev)
    max_ts = torch.tensor(TS0 - TS0 % HOUR_MS, dtype=torch.int64, device=dev)
    args = (reprs, valid, ts, active, HOUR_MS, 24 * HOUR_MS, max_ts, capacity)
    got = hs.row_prologue(*args)
    want = hs.row_prologue_plain(*args)
    names = ("wstart", "knull", "active", "khash", "base", "c0")
    err = max(_assert_equal(torch, f"row_prologue.{nm}", g, w) for nm, g, w in zip(names, got, want))
    require(0 < int(got[2].sum()) < n, "row_prologue: grace cut should drop some rows and keep others")
    k = reprs.shape[0]
    rec = measure(torch, "row_prologue", lambda: hs.row_prologue(*args),
                  lambda: hs.row_prologue_plain(*args),
                  n * (9 * k + 9 + 33), n * (30 * (k + 1) + 20))
    recs["row_prologue"] = dict(rec, max_abs_err=err)
    _report("2", "row_prologue", recs["row_prologue"])

    # ---- K2 probe_insert: 70%-full store with graves, zipf keys
    layout, store0 = make_store(torch, hs, capacity, int(0.7 * capacity), rng, url_hashes, dev)
    wstart, knull, act, khash, base, c0 = got
    # rows land in the store's recent windows: mostly matches, some new keys
    pin = (wstart, knull, act, khash, base)
    store_k, store_p = _clone(store0), _clone(store0)
    scratch = hs.init_scratch(capacity, dev)
    slots_k = hs.probe_insert(store_k, scratch, capacity, base, khash, wstart, reprs, knull, act)
    slots_p = hs.probe_insert_plain(store_p, capacity, base, khash, wstart, reprs, knull, act)
    _assert_equal(torch, "probe_insert.slots", slots_k, slots_p)
    for key in store0:
        _assert_equal(torch, f"probe_insert.{key}", store_k[key], store_p[key])
    require(bool((scratch["claim"] == hs.INT32_MAX).all()), "probe_insert: claim cells not clean")
    new_keys = int(store_k["occ"].sum() - store0["occ"].sum())
    reclaimed = int((store0["grave"] & ~store_k["grave"]).sum())
    matched = int(act.sum()) - new_keys
    print(f"[2] probe_insert: exact; {new_keys} new keys, {reclaimed} graves reclaimed, "
          f"overflow {int(store_k['overflow'])}")
    require(reclaimed > 0 and new_keys > 0, "probe_insert: data should exercise claims and graves")
    work = _clone(store0)

    def reset_k2():
        _restore(work, store0)

    def k2():
        hs.probe_insert(work, scratch, capacity, base, khash, wstart, reprs, knull, act)

    n_act = int(act.sum())
    rec = measure(torch, "probe_insert", k2,
                  lambda: hs.probe_insert_plain(work, capacity, base, khash, wstart, reprs, knull, act),
                  n * (4 + 8 + 8 + 8 * k + 4 + 1) + n * 4 + n_act * 18
                  + new_keys * (1 + 1 + 8 + 8 + 8 * k + 4), n * 40, reset=reset_k2, plain_reps=10)
    recs["probe_insert"] = dict(rec, max_abs_err=0.0)
    _report("2", f"probe_insert ({matched} rows matched)", recs["probe_insert"])

    # ---- K3 fold_and_mark: the flagship's components at its shapes, then
    # every combine x dtype (float64 sums to rtol 1e-12, NaNs included)
    slots = slots_k
    ones = act.to(torch.int64)
    flag_contribs = [c0, ones]
    err3 = 0.0
    variants = [(layout, flag_contribs)]
    wide = hs.StoreLayout(capacity, 1, layout.components + (
        hs.AggComponent("add", "float64", 0.0),
        hs.AggComponent("min", "float64", float("inf")),
        hs.AggComponent("max", "float64", float("-inf")),
        hs.AggComponent("min", "int64", np.iinfo(np.int64).max),
        hs.AggComponent("add", "int32", 0),
        hs.AggComponent("max", "int32", 0),
    ), windowed=True)
    x = rng.standard_normal(n) * 1e3
    x[rng.random(n) < 0.001] = np.nan
    xd = torch.from_numpy(x).to(dev)
    zero = torch.zeros((), dtype=torch.float64, device=dev)
    wide_contribs = flag_contribs + [
        torch.where(act, torch.nan_to_num(xd), zero),
        torch.where(act, xd, torch.full_like(xd, float("inf"))),
        torch.where(act, xd, torch.full_like(xd, float("-inf"))),
        torch.where(act, ts, torch.full_like(ts, np.iinfo(np.int64).max)),
        act.to(torch.int32),
        act.to(torch.int32),
    ]
    variants.append((wide, wide_contribs))
    for lay, contribs in variants:
        base_store = _clone(store_k)
        for j, comp in enumerate(lay.components[2:], start=2):
            base_store[f"a{j}"] = torch.full((capacity + 1,), comp.init, dtype=hs._DTYPES[comp.dtype], device=dev)
        sk, sp = _clone(base_store), _clone(base_store)
        win_k = hs.fold_and_mark(sk, scratch, lay, slots, contribs, act)
        win_p = hs.fold_and_mark_plain(sp, lay, slots, contribs, act)
        _assert_equal(torch, "fold_and_mark.winners", win_k, win_p)
        require(bool((scratch["first"] == hs.INT32_MAX).all()), "fold_and_mark: first cells not clean")
        for key in base_store:
            comp = lay.components[int(key[1:])] if key.startswith("a") else None
            rtol = 1e-12 if comp is not None and comp.combine == "add" and comp.dtype == "float64" else 0.0
            err3 = max(err3, _assert_equal(torch, f"fold_and_mark.{key}", sk[key], sp[key], rtol))
    work = _clone(store_k)

    def reset_k3():
        _restore(work, store_k)

    def k3():
        hs.fold_and_mark(work, scratch, layout, slots, flag_contribs, act)

    sl = slots.long()
    touched = int(torch.unique(slots[act]).numel())
    rec = measure(torch, "fold_and_mark", k3,
                  lambda: hs.fold_and_mark_plain(work, layout, slots, flag_contribs, act),
                  n * (4 + 1 + 16) + touched * (2 * 16 + 1) + n, n * 6, reset=reset_k3,
                  plain_reps=10,
                  library=lambda: (work["a0"].index_reduce_(0, sl, c0, "amax"),
                                   work["a1"].index_add_(0, sl, ones)))
    recs["fold_and_mark"] = dict(rec, max_abs_err=err3)
    _report("2", "fold_and_mark (yardstick index_reduce_ amax + index_add_)", recs["fold_and_mark"])
    # K3 on phase 3's own traffic (17 ms apart: about a quarter of the rows
    # on one slot), the contention its warp combine is for; printed only
    fst, fscratch, flayout, fslots, fcontribs, fact = make_fold_case(
        torch, hs, np.random.default_rng(seed + 5), dev, "flagship", n, capacity)
    fk, fp = _clone(fst), _clone(fst)
    _assert_equal(torch, "fold_and_mark[flagship].winners",
                  hs.fold_and_mark(fk, fscratch, flayout, fslots, fcontribs, fact),
                  hs.fold_and_mark_plain(fp, flayout, fslots, fcontribs, fact))
    for key in fst:
        _assert_equal(torch, f"fold_and_mark[flagship].{key}", fk[key], fp[key])
    hot = int(torch.bincount(fslots[fact].long()).max())
    rec = measure(torch, "fold_and_mark", lambda: hs.fold_and_mark(fk, fscratch, flayout, fslots, fcontribs, fact),
                  lambda: hs.fold_and_mark_plain(fp, flayout, fslots, fcontribs, fact),
                  fold_bytes(torch, fslots, fact, fcontribs), n * 6, plain_reps=5)
    _report("2", f"fold_and_mark at phase 3's timestamps ({n} rows, the hottest slot {hot})",
            dict(rec, max_abs_err=0.0))
    del fst, fk, fp, fscratch

    # ---- K4 evict: the same store, stream time past the oldest windows
    ev0 = _clone(store_k)
    ev0["max_ts"].fill_(int(store_k["wstart"][store_k["occ"]].min()) + 25 * HOUR_MS + 4 * HOUR_MS)
    rec, expired, _ek = check_evict(torch, layout, ev0, 25 * HOUR_MS)
    require(expired > 0, "evict: data should expire some slots")
    recs["evict"] = rec
    _report("2", f"evict ({expired} slots expired)", recs["evict"])
    return recs


def evict_bytes(layout, store, expired, sliced=False, suppress=False):
    """K4's least bytes: each slot's ``occ`` read, an occupied slot's start
    (``wstart`` or ``slast``; and ``dirty`` under suppress) read, an
    expired slot's flags, ``born``/``emitted``/``hpass`` where the store
    keeps them, ``slast`` and its ``slice_id`` row (sliced) and every cell
    of every component written once."""
    c1 = layout.capacity + 1
    occ_n = int(store["occ"].sum())
    per = 3 + ("hpass" in store) + (9 if "born" in store else 0)
    if sliced:
        per += 8 + 8 * layout.components[0].width
    per += sum(store[f"a{j}"].element_size() * comp.width for j, comp in enumerate(layout.components))
    return c1 + occ_n * (9 if suppress else 8) + expired * per


def check_evict(torch, layout, ev0, retention, sliced=False, suppress=False):
    """K4 on ``ev0`` (a store whose ``max_ts`` puts some slots past
    ``retention``) against its twin on copies: every column exact (bits),
    then timed from ``ev0`` every launch.  Returns the record, the count of
    expired slots and the kernel's store."""
    from ksql_tpu_torch.ops import hash_store as hs

    mode = "suppress" if suppress else "sliced" if sliced else "tumbling"
    ek, ep, work = _clone(ev0), _clone(ev0), _clone(ev0)
    hs.evict(ek, layout, retention, sliced=sliced, suppress=suppress)
    hs.evict_plain(ep, layout, retention, sliced=sliced, suppress=suppress)
    for key in ev0:
        _assert_equal(torch, f"evict[{mode}].{key}", _bits(torch, ek[key]), _bits(torch, ep[key]))
    expired = int((ev0["occ"] & ~ek["occ"]).sum())
    rec = measure(torch, "evict", lambda: hs.evict(work, layout, retention, sliced=sliced, suppress=suppress),
                  lambda: hs.evict_plain(work, layout, retention, sliced=sliced, suppress=suppress),
                  evict_bytes(layout, ev0, expired, sliced, suppress), (layout.capacity + 1) * 4,
                  reset=lambda: _restore(work, ev0))
    return dict(rec, max_abs_err=0.0), expired, ek


def phase_k2_batch(torch, seed, n=1 << 20, capacity=STORE):
    """K2 at phase 12g's batch (2^20 rows: its cooperative grid walks more
    rows than the card holds threads) into a 2^20-slot store 30% full with
    graves, the rows zipf(1.3) URLs over 31 h as phase 2's: exact against
    the twin, claim cells clean; returns its record."""
    from ksql_tpu_torch.common.batch import stable_hash64
    from ksql_tpu_torch.ops import hash_store as hs

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(seed + 30)
    url_hashes = np.fromiter((stable_hash64(u) for u in _urls(N_URLS)), np.int64, N_URLS)
    uid = rng.zipf(1.3, n).astype(np.int64) % N_URLS
    reprs = torch.from_numpy(url_hashes[uid].reshape(1, n)).to(dev)
    valid = torch.from_numpy(rng.random((1, n)) > 0.01).to(dev)
    ts = torch.from_numpy(TS0 - 30 * HOUR_MS + np.sort(rng.integers(0, 31 * HOUR_MS, n))).to(dev)
    active = torch.from_numpy(np.arange(n) < n - 17).to(dev)
    max_ts = torch.tensor(TS0 - TS0 % HOUR_MS, dtype=torch.int64, device=dev)
    wstart, knull, act, khash, base, _c0 = hs.row_prologue_plain(
        reprs, valid, ts, active, HOUR_MS, 24 * HOUR_MS, max_ts, capacity)
    _layout, store0 = make_store(torch, hs, capacity, int(0.3 * capacity), rng, url_hashes, dev)
    args = (capacity, base, khash, wstart, reprs, knull, act)
    scratch = hs.init_scratch(capacity, dev)
    got = _check_insert(torch, hs, f"probe_insert[{n}]", store0, scratch, args)
    new_keys = int((got["occ"] & ~store0["occ"] & ~store0["grave"]).sum())
    ibytes, probes = insert_bytes(got["slots"], base.cpu().numpy(), act.cpu().numpy(), new_keys, capacity,
                                  hs.MAX_PROBES)
    work = _clone(store0)
    rec = measure(torch, "probe_insert", lambda: hs.probe_insert(work, scratch, *args),
                  lambda: hs.probe_insert_plain(work, *args), ibytes, n * 40,
                  reset=lambda: _restore(work, store0), plain_reps=3)
    rec["max_abs_err"] = 0.0
    _report("2", f"probe_insert at 12g's batch ({n} rows into {capacity} slots 30% full, {new_keys} new, "
            f"{probes} probes, overflow {int(got['overflow']) - int(store0['overflow'])})", rec)
    return rec


# ------------------------------------------------------------- phase 2h
#: BASELINE #2's store components (``bench.py:207``): the watermark, then
#: SUM, AVG, MIN and MAX of a BIGINT
HOP_COMPONENTS = (
    ("max", "int64", np.iinfo(np.int64).min),
    ("add", "int64", 0),
    ("add", "float64", 0.0), ("add", "int64", 0),
    ("min", "int64", np.iinfo(np.int64).max), ("max", "int32", 0),
    ("max", "int64", np.iinfo(np.int64).min), ("max", "int32", 0),
)
SLICE_MS = 15 * 60_000  # BASELINE #2's slice width: gcd(1 h, 15 min)


def _cell_values(rng, comp, shape, specials):
    """Random values a folded cell or a contribution of ``comp`` can hold;
    with ``specials`` a float column also gets NaN, -0.0 and +0.0."""
    if comp.dtype == "float64":
        # non-negative: float sums then carry no cancellation, so a
        # different fold order stays within rtol 1e-12
        v = np.round(rng.random(shape) * 1000.0, 3)
        if specials:
            pick = rng.random(shape)
            v[pick < 0.02] = np.nan
            v[(pick >= 0.02) & (pick < 0.06)] = -0.0
            v[(pick >= 0.06) & (pick < 0.10)] = 0.0
        return v
    if comp.dtype == "int32":
        return rng.integers(0, 2, shape).astype(np.int32) if comp.combine == "max" else \
            rng.integers(-1000, 1000, shape).astype(np.int32)
    return rng.integers(0, 1000, shape).astype(np.int64)


def make_sliced_case(hs, rng, capacity, ring, n, components=HOP_COMPONENTS,
                     fill=0.7, width=SLICE_MS, specials=False, one_slot=False):
    """A sliced store and a batch of ``n`` rows against it, as numpy.

    The store (``capacity + 1`` slots, a ring of ``ring`` cells per
    component) is ``fill`` full of keys, 5% of them graves; a live slot's
    ring cells hold its slices of the last ``ring - 1`` slice indices, a
    slice of an earlier ring wrap (stale) or nothing (-1).  The batch's
    slots are zipf(1.3) over the live keys (so several rows write one ring
    cell), 10% free slots (new keys), 2% active rows that overflowed into
    the dump slot and 10% inactive rows (dump slot, garbage timestamps);
    the active rows' slices lie within the ring's horizon, as K1 admits
    them.  ``one_slot`` sends every active row to one key whose slices
    span the whole ring (the ring-cap case of K7).  Returns ``(layout,
    store, rows)``; ``rows`` holds ``slots`` int32, ``active``, ``wstart``
    (slice starts), ``contribs`` (identity where inactive) and ``max_ts``."""
    comps = tuple(hs.AggComponent(c, d, i, ring) for c, d, i in components)
    layout = hs.StoreLayout(capacity, 1, comps, windowed=True)
    c1 = capacity + 1
    newest = 1_888_888  # slice index of the batch's newest slice
    store = {k: v.numpy().copy() for k, v in hs.init_store(layout, "cpu").items()}
    store["slice_id"] = np.full((c1, ring), -1, np.int64)
    store["slast"] = np.full(c1, hs.SLAST_NONE, np.int64)
    live = rng.choice(capacity, max(1, int(fill * capacity)), replace=False)
    store["occ"][live] = True
    store["khash"][live] = rng.integers(-2**62, 2**62, live.size)
    store["key0"][live] = store["khash"][live]
    pos = np.arange(ring)
    # the live slice index held at each ring position: newest - ring + 2 ..
    # newest, one per position (the position of newest - ring + 1 is free)
    live_sid = newest - ((newest - pos) % ring)
    kind = rng.random((live.size, ring))
    sid = np.where(kind < 0.6, live_sid, np.where(kind < 0.8, live_sid - ring, -1))
    sid[:, (newest + 1) % ring] = np.where(kind[:, 0] < 0.5, newest + 1 - ring, -1)
    store["slice_id"][live] = sid
    held = sid >= 0
    for j, comp in enumerate(comps):
        col = store[f"a{j}"]
        vals = _cell_values(rng, comp, (live.size, ring), specials)
        if j == 0:
            vals = np.maximum(sid, 0) * width + rng.integers(0, width, (live.size, ring))
        col[live] = np.where(held, vals, col[live])
    store["slast"][live] = np.where(sid >= newest - ring + 2, sid, -1).max(axis=1) * width
    store["slast"][live[store["slast"][live] < 0]] = hs.SLAST_NONE
    store["dirty"][live] = rng.random(live.size) < 0.5
    graves = live[rng.random(live.size) < 0.05]
    store["occ"][graves] = False
    store["grave"][graves] = True
    store["slice_id"][graves] = -1
    store["slast"][graves] = hs.SLAST_NONE
    for j, comp in enumerate(comps):
        store[f"a{j}"][graves] = comp.init
    store["max_ts"] = np.array((newest - 2) * width, np.int64)
    occupied = np.nonzero(store["occ"][:-1])[0]
    free = np.nonzero(~(store["occ"] | store["grave"])[:-1])[0]
    kind = rng.random(n)
    if one_slot:
        slots = np.full(n, occupied[0], np.int64)
        sidx = newest - rng.integers(0, ring - 1, n)
    else:
        slots = occupied[(rng.zipf(1.3, n) - 1) % occupied.size]
        new_rows = (kind < 0.10) & (free.size > 0)
        if free.size:
            slots[new_rows] = free[rng.integers(0, free.size, n)][new_rows]
        # recent slices most often: duplicate writers of one ring cell
        sidx = newest - np.minimum(rng.geometric(0.3, n) - 1, ring - 2)
    slots[(kind >= 0.10) & (kind < 0.12)] = capacity  # overflowed
    inactive = kind >= 0.90
    active = ~inactive
    slots[inactive] = capacity
    sidx[inactive] = rng.integers(-5, 2 * newest, inactive.sum())
    wstart = sidx * width
    ts = wstart + rng.integers(0, width, n)
    contribs = []
    for j, comp in enumerate(comps):
        v = ts.copy() if j == 0 else _cell_values(rng, comp, n, specials)
        ident = 0 if comp.combine == "add" else comp.init
        contribs.append(np.where(active, v, np.array(ident).astype(v.dtype)).astype(comp.dtype))
    rows = {"slots": slots.astype(np.int32), "active": active, "wstart": wstart,
            "contribs": contribs, "max_ts": np.array((newest - 2) * width, np.int64)}
    return layout, store, rows


def check_sliced_fold(torch, layout, store_np, rows, dev, scratch_spw=HOUR_MS // SLICE_MS):
    """K5 on a ``make_sliced_case`` case: the kernel against its twin on
    copies of the store (float64 adds at rtol 1e-12, every other cell
    exact, ``ring_last`` clean after the call), then timed from the same
    store every launch.  Returns the kernel's folded store, the record and
    what the case holds."""
    from ksql_tpu_torch.ops import slicing

    capacity, ring = layout.capacity, layout.components[0].width
    n = rows["slots"].shape[0]
    store0 = {key: torch.from_numpy(v).to(dev) for key, v in store_np.items()}
    slots = torch.from_numpy(rows["slots"]).to(dev)
    act = torch.from_numpy(rows["active"]).to(dev)
    wstart = torch.from_numpy(rows["wstart"]).to(dev)
    contribs = [torch.from_numpy(c).to(dev) for c in rows["contribs"]]
    scratch = slicing.init_slice_scratch(capacity, ring, scratch_spw, dev)
    sk, sp = _clone(store0), _clone(store0)
    slicing.sliced_fold(sk, scratch, layout, slots, wstart, contribs, act, SLICE_MS)
    slicing.sliced_fold_plain(sp, layout, slots, wstart, contribs, act, SLICE_MS)
    err = 0.0
    for key in store0:
        comp = layout.components[int(key[1:])] if key[0] == "a" and key[1:].isdigit() else None
        rtol = 1e-12 if comp is not None and comp.dtype == "float64" else 0.0
        err = max(err, _assert_equal(torch, f"sliced_fold.{key}", sk[key], sp[key], rtol))
    require(bool((scratch["ring_last"] == -1).all()), "sliced_fold: ring_last not clean")
    live = act & (slots != capacity)
    sidx = torch.div(wstart, SLICE_MS, rounding_mode="floor")
    cell = slots.long() * ring + torch.remainder(sidx, ring)
    stale = int((live & (store0["slice_id"].view(-1)[cell] != sidx)).sum())
    cells = int(torch.unique(torch.where(live, cell, capacity * ring)).numel())
    touched = int(torch.unique(slots[live]).numel())
    hot = int(torch.bincount(slots[live].long()).max()) if bool(live.any()) else 0
    cbytes = sum(np.dtype(c.dtype).itemsize for c in layout.components)
    work = _clone(store0)
    flat = (slots.long() * ring + torch.remainder(sidx, ring)).clamp(max=(capacity + 1) * ring - 1)
    rec = measure(torch, "sliced_fold",
                  lambda: slicing.sliced_fold(work, scratch, layout, slots, wstart, contribs, act, SLICE_MS),
                  lambda: slicing.sliced_fold_plain(work, layout, slots, wstart, contribs, act, SLICE_MS),
                  n * (4 + 8 + 1 + cbytes) + cells * 2 * (8 + cbytes) + touched * 2 * 9,
                  n * 40, reset=lambda: _restore(work, store0), plain_reps=10,
                  library=lambda: [work[f"a{j}"].view(-1).index_add_(0, flat, c.to(work[f"a{j}"].dtype))
                                   if comp.combine == "add" else
                                   work[f"a{j}"].view(-1).index_reduce_(
                                       0, flat, c.to(work[f"a{j}"].dtype),
                                       "amin" if comp.combine == "min" else "amax")
                                   for j, (comp, c) in enumerate(zip(layout.components, contribs))])
    rec["max_abs_err"] = err
    what = (f"{n} rows, {int(live.sum())} live, {stale} stale cells reset, {cells} cells of {touched} slots, "
            f"hottest slot {hot} rows; yardstick index_add_/index_reduce_ per component")
    return sk, rec, what


def phase_hop_kernels(torch, seed, n=HOP_ROWS, capacity=HOP_STORE, ring=HOP_RING):
    """The hopping path's kernels and modes against their twins at BASELINE
    #2's shapes: K1's sliced and expansion modes, K5, K7, K6 (sliced, and
    its plain gather at the flagship's shapes) and K4's sliced branch.
    Returns ``{kernel: {mode: record}}``."""
    from ksql_tpu_torch.common.batch import stable_hash64
    from ksql_tpu_torch.ops import hash_store as hs
    from ksql_tpu_torch.ops import slicing

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(seed + 10)
    url_hashes = np.fromiter((stable_hash64(u) for u in _urls(N_URLS)), np.int64, N_URLS)
    recs: dict = {"row_prologue": {}, "evict": {}, "combine_windows": {}}
    size, adv, grace = HOUR_MS, 15 * 60_000, 24 * HOUR_MS
    spw, k = HOUR_MS // SLICE_MS, HOUR_MS // adv

    # ---- K1, sliced and expansion: rows over 31 h against a batch-start
    # clock 1 h before the newest row, so admission and horizon both cut
    uid = rng.zipf(1.3, n).astype(np.int64) % N_URLS
    reprs = torch.from_numpy(url_hashes[uid].reshape(1, n)).to(dev)
    valid = torch.from_numpy(rng.random((1, n)) > 0.01).to(dev)
    ts = torch.from_numpy(TS0 - 30 * HOUR_MS + np.sort(rng.integers(0, 31 * HOUR_MS, n))).to(dev)
    active = torch.from_numpy(np.arange(n) < n - 17).to(dev)
    max_ts = torch.tensor(TS0, dtype=torch.int64, device=dev)
    for mode, hop in (("sliced", dict(advance_ms=adv, slice_width=SLICE_MS, slice_ring=ring)),
                      ("expansion", dict(advance_ms=adv))):
        args = (reprs, valid, ts, active, size, grace, max_ts, capacity)
        got = hs.row_prologue(*args, **hop)
        want = hs.row_prologue_plain(*args, **hop)
        for nm, g, w in zip(("wstart", "knull", "active", "khash", "base", "c0"), got, want):
            _assert_equal(torch, f"row_prologue[{mode}].{nm}", g, w)
        kept = int(got[2].sum())
        require(0 < kept < got[2].numel() - 17 * (k if mode == "expansion" else 1),
                f"row_prologue[{mode}]: the cuts should drop some rows and keep others")
        lanes = got[0].numel()
        rec = measure(torch, "row_prologue", lambda: hs.row_prologue(*args, **hop),
                      lambda: hs.row_prologue_plain(*args, **hop),
                      n * (9 + 9 + 8) + 8 + lanes * 33, n * 90 + lanes * 30)
        rec["max_abs_err"] = 0.0
        recs["row_prologue"][mode] = rec
        _report("2h", f"row_prologue[{mode}] ({lanes} lanes, {kept} admitted)", rec)

    # ---- K5 sliced_fold on a 70%-full ring store with stale cells
    layout, store_np, rows = make_sliced_case(hs, rng, capacity, ring, n)
    sk, rec, what = check_sliced_fold(torch, layout, store_np, rows, dev, scratch_spw=spw)
    slots = torch.from_numpy(rows["slots"]).to(dev)
    act = torch.from_numpy(rows["active"]).to(dev)
    wstart = torch.from_numpy(rows["wstart"]).to(dev)
    scratch = slicing.init_slice_scratch(capacity, ring, spw, dev)
    cbytes = sum(np.dtype(c.dtype).itemsize for c in layout.components)
    recs["sliced_fold"] = {"sliced": rec}
    _report("2h", f"sliced_fold ({what})", rec)

    # ---- K7 member_lanes on the folded store (the stream time at batch
    # start closes the oldest windows)
    args = (slots, act, wstart, sk["max_ts"], capacity, SLICE_MS, spw, adv, size, grace, k)
    got = slicing.member_lanes(*args, scratch)
    want = slicing.member_lanes_plain(*args)
    for nm, g, w in zip(("w_lane", "slot_lane", "winner"), got, want):
        _assert_equal(torch, f"member_lanes.{nm}", g, w)
    require(bool((scratch["lanes"] == hs.INT32_MAX).all()), "member_lanes: claims not clean")
    w_lane, slot_lane, winner = want
    nn = n * k
    n_win = int(winner.sum())
    rec = measure(torch, "member_lanes", lambda: slicing.member_lanes(*args, scratch),
                  lambda: slicing.member_lanes_plain(*args),
                  n * 13 + 8 + nn * 13 + n_win * 8, nn * 40, plain_reps=10)
    rec["max_abs_err"] = 0.0
    recs["member_lanes"] = {"sliced": rec}
    _report("2h", f"member_lanes ({nn} lanes, {n_win} winners)", rec)

    # ---- K6 combine_windows over those lanes, S = 4 slices per window
    got = slicing.combine_windows(sk, layout, 1, slot_lane, w_lane, spw, SLICE_MS)
    want = slicing.combine_windows_plain(sk, layout, 1, slot_lane, w_lane, spw, SLICE_MS)
    err = max(_assert_equal(torch, f"combine_windows.{nm}", got[nm], want[nm],
                            1e-12 if want[nm].is_floating_point() else 0.0) for nm in want)
    ids = w_lane[:, None] + torch.arange(spw, device=dev)
    flat = slot_lane.long()[:, None] * ring + torch.remainder(ids, ring)
    cells = int(torch.unique(flat).numel())
    slots6 = int(torch.unique(slot_lane).numel())
    cols = [sk[f"a{j}"] for j in range(len(layout.components))]

    def yardstick():
        # torch.gather + sum/amax/amin over dim 1, per component (not used
        # by the port)
        ok = torch.gather(sk["slice_id"].view(-1), 0, flat.view(-1)).view_as(flat) == ids
        for comp, col in zip(layout.components, cols):
            cellv = torch.gather(col.view(-1), 0, flat.view(-1)).view_as(flat)
            cellv = torch.where(ok, cellv, torch.tensor(comp.init, dtype=col.dtype, device=dev))
            {"add": lambda x: x.sum(1), "min": lambda x: x.amin(1), "max": lambda x: x.amax(1)}[comp.combine](cellv)

    rec = measure(torch, "combine_windows",
                  lambda: slicing.combine_windows(sk, layout, 1, slot_lane, w_lane, spw, SLICE_MS),
                  lambda: slicing.combine_windows_plain(sk, layout, 1, slot_lane, w_lane, spw, SLICE_MS),
                  nn * 12 + cells * (8 + cbytes) + slots6 * 12 + nn * (cbytes + 20),
                  nn * spw * len(layout.components) * 4, library=yardstick)
    rec["max_abs_err"] = err
    recs["combine_windows"]["sliced"] = rec
    _report("2h", f"combine_windows[sliced] ({nn} lanes x {spw} slices, {cells} cells)", rec)

    # ---- K6 plain gather (S = 1) at the flagship's shapes
    flag_layout, flag_store = make_store(torch, hs, STORE, int(0.7 * STORE), rng, url_hashes, dev)
    fslots = torch.from_numpy(rng.integers(0, STORE + 1, N_ROWS).astype(np.int32)).to(dev)
    got = slicing.combine_windows(flag_store, flag_layout, 1, fslots)
    want = slicing.combine_windows_plain(flag_store, flag_layout, 1, fslots)
    for nm in want:
        _assert_equal(torch, f"combine_windows[gather].{nm}", got[nm], want[nm])
    fidx = fslots.long()
    rec = measure(torch, "combine_windows",
                  lambda: slicing.combine_windows(flag_store, flag_layout, 1, fslots),
                  lambda: slicing.combine_windows_plain(flag_store, flag_layout, 1, fslots),
                  N_ROWS * 4 + N_ROWS * (16 + 8 + 8 + 4) * 2, N_ROWS * 10,
                  library=lambda: [flag_store[c].index_select(0, fidx)
                                   for c in ("a0", "a1", "wstart", "key0", "knull")])
    rec["max_abs_err"] = 0.0
    recs["combine_windows"]["gather"] = rec
    _report("2h", f"combine_windows[gather] ({N_ROWS} lanes, 2^20 slots)", rec)
    del flag_store

    # ---- K4 sliced: half the keys' newest slice left the retention
    retention = 25 * HOUR_MS
    ev0 = _clone(sk)
    ev0["max_ts"].fill_(int(sk["slast"][sk["occ"]].median()) + retention)
    rec, expired, ek = check_evict(torch, layout, ev0, retention, sliced=True)
    require(expired > 0 and bool(ek["occ"].any()), "evict[sliced]: data should expire some slots")
    recs["evict"]["sliced"] = rec
    _report("2h", f"evict[sliced] ({expired} keys expired, ring {ring})", rec)
    return recs


# ------------------------------------------------------------- phase 2j
JOIN_ROWS = 1 << 16  # BASELINE #3's batch (bench.py CAPACITY)
JOIN_STORE = 1 << 18  # bench.py:557, the table store of bench_stream_table_join
JOIN_USERS = 100_000  # bench.py:556
N_REGIONS = 50
#: BASELINE #3's table columns (ENRICHED keeps U_REGION, a string hash)
JOIN_COLS = (("U_REGION", "int64"),)
_NP = {"int64": np.int64, "int32": np.int32, "float64": np.float64, "bool": np.bool_}


def _col_values(rng, dtype, n):
    if dtype == "float64":
        return np.round(rng.standard_normal(n) * 1e3, 3)
    if dtype == "bool":
        return rng.random(n) < 0.5
    info = np.iinfo(_NP[dtype])
    return rng.integers(info.min, info.max, n, dtype=_NP[dtype])


def make_join_case(torch, hs, rng, capacity, n_users, cols=JOIN_COLS, grave_frac=0.05):
    """A join table store, as numpy: users 0..n_users-1 keyed as the
    table step keys them (key0 = id, khash = combine_hash([id]), window
    0), a fraction ``grave_frac`` of them deleted (graves), and per column
    of ``cols`` a ``v_``/``m_`` pair of random values (5% null); the dump
    row holds a row's values, as an earlier batch leaves it."""
    st = {k: v.numpy().copy() for k, v in hs.init_store(hs.StoreLayout(capacity, 1, ()), "cpu").items()}
    ids = np.arange(n_users, dtype=np.int64)
    khash = hs.combine_hash([torch.from_numpy(ids)]).numpy()
    slots = fill_store(hs, st["occ"], st["khash"], st["wstart"], capacity, khash, np.zeros(n_users, np.int64))
    st["key0"][slots] = ids
    for name, dtype in cols:
        v = np.zeros(capacity + 1, _NP[dtype])
        m = np.zeros(capacity + 1, bool)
        v[slots] = _col_values(rng, dtype, n_users)
        m[slots] = rng.random(n_users) > 0.05
        v[capacity], m[capacity] = v[slots[0]], True
        st[f"v_{name}"], st[f"m_{name}"] = v, m
    graves = slots[rng.random(n_users) < grave_frac]
    st["occ"][graves] = False
    st["grave"][graves] = True
    return st


def probe_walk(hs, store, capacity, krepr, look):
    """The reference's find walk replayed in numpy: (slots read, distinct
    slots read) by the rows ``look`` (the data-dependent part of K8's
    bound)."""
    mask = capacity - 1
    gold = np.uint64(0x9E3779B97F4A7C15)
    h = hs.np_mix64(((krepr.astype(np.int64).view(np.uint64) + gold) ^ gold).view(np.int64))
    cand = hs.np_mix64(h) & mask
    todo = np.nonzero(look)[0]
    seen = []
    for _ in range(32):
        if not todo.size:
            break
        c = cand[todo]
        seen.append(c)
        hit = store["occ"][c] & (store["khash"][c] == h[todo])
        empty = ~(store["occ"][c] | store["grave"][c])
        keep = ~(hit | empty)
        todo = todo[keep]
        cand[todo] = (cand[todo] + 1) & mask
    allc = np.concatenate(seen) if seen else np.zeros(0, np.int64)
    return allc.size, np.unique(allc).size


def table_batch(rng, n, n_users, pad=100):
    """A changelog batch of ``n`` rows: keys over 1.1 x ``n_users`` (so
    some are new and repeat in the batch), 5% tombstones (some of absent
    keys), 1% delete + re-insert pairs, 0.5% null keys and ``pad``
    inactive rows at the end.  Returns (keys, key valid, delete, active)."""
    keys = rng.integers(0, int(n_users * 1.1), n)
    dels = rng.random(n) < 0.05
    pairs = rng.choice(n - 1, n // 100, replace=False)
    dels[pairs], dels[pairs + 1] = True, False
    keys[pairs + 1] = keys[pairs]
    return keys, rng.random(n) > 0.005, dels, np.arange(n) < n - pad


def phase_join_kernels(torch, seed, n=JOIN_ROWS, capacity=JOIN_STORE, n_users=JOIN_USERS):
    """BASELINE #3's kernels against their twins at its shapes: K8
    probe_find (65,536 stream rows, keys uniform over 0..199,999 so about
    half match, into a 2^18-slot table of 100,000 users with 5% graves),
    K1's table mode, and K9 table_upsert after K2 on a 65,536-row
    changelog batch.  Everything exact, the dump row included.  Returns
    ``{kernel: {mode: record}}``."""
    from ksql_tpu_torch.ops import hash_store as hs

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(seed + 20)
    st_np = make_join_case(torch, hs, rng, capacity, n_users)
    store = {k: torch.from_numpy(v).to(dev) for k, v in st_np.items()}
    cols = [c for c, _ in JOIN_COLS]
    recs: dict = {}

    # ---- K8 probe_find
    uid = rng.integers(0, 2 * n_users, n)
    kvalid_np = rng.random(n) > 0.01
    active_np = np.arange(n) < n - 17
    krepr = torch.from_numpy(uid).to(dev)
    kvalid = torch.from_numpy(kvalid_np).to(dev)
    active = torch.from_numpy(active_np).to(dev)
    args = (store, capacity, krepr, kvalid, active, cols)
    got = hs.probe_find(*args)
    want = hs.probe_find_gather_plain(*args)
    for nm in want[0]:
        _assert_equal(torch, f"probe_find.{nm}", got[0][nm], want[0][nm])
    _assert_equal(torch, "probe_find.key0", got[1], want[1])
    _assert_equal(torch, "probe_find.found", got[2], want[2])
    n_found = int(want[2].sum())
    require(0.3 * n < n_found < 0.7 * n, f"probe_find: {n_found} of {n} rows found, about half expected")
    reads, distinct = probe_walk(hs, st_np, capacity, uid, kvalid_np & active_np)
    look = active & kvalid
    slots = hs.probe_find_plain(store, capacity, hs.combine_hash([krepr]),
                                torch.zeros_like(krepr), look).long()
    gathered = int(torch.unique(slots).numel())
    width = sum(np.dtype(_NP[d]).itemsize + 1 for _, d in JOIN_COLS)
    rec = measure(torch, "probe_find", lambda: hs.probe_find(*args),
                  lambda: hs.probe_find_gather_plain(*args),
                  n * (8 + 1 + 1) + n * (8 + 1 + width) + distinct * 18 + gathered * (8 + width),
                  n * 40 + reads * 6,
                  library=lambda: [store[c].index_select(0, slots)
                                   for c in ["key0"] + [f"{p}_{c}" for c in cols for p in "vm"]])
    recs["probe_find"] = {"join": dict(rec, max_abs_err=0.0)}
    _report("2j", f"probe_find ({n_found} of {n} rows found, {reads} slot reads, "
            f"yardstick index_select per column)", recs["probe_find"]["join"])

    # ---- K1 table mode on a changelog batch
    keys, kv, dels, tact = table_batch(rng, n, n_users)
    reprs = torch.from_numpy(keys.reshape(1, n)).to(dev)
    kv2 = torch.from_numpy(kv.reshape(1, n)).to(dev)
    tactive = torch.from_numpy(tact).to(dev)
    delete = torch.from_numpy(dels).to(dev)
    pargs = (reprs, kv2, tactive, capacity)
    got = hs.table_prologue(*pargs)
    want = hs.table_prologue_plain(*pargs)
    for nm, g, w in zip(("active", "khash", "base"), got, want):
        _assert_equal(torch, f"row_prologue[table].{nm}", g, w)
    # reads repr, valid and active; writes active, khash and base
    rec = measure(torch, "row_prologue", lambda: hs.table_prologue(*pargs),
                  lambda: hs.table_prologue_plain(*pargs),
                  n * (8 + 1 + 1) + n * (1 + 8 + 4), n * 30)
    recs["row_prologue"] = {"table": dict(rec, max_abs_err=0.0)}
    _report("2j", "row_prologue[table]", recs["row_prologue"]["table"])

    # ---- K2 then K9 table_upsert, each against its twin
    act, khash, base = got
    zeros64 = torch.zeros(n, dtype=torch.int64, device=dev)
    zeros32 = torch.zeros(n, dtype=torch.int32, device=dev)
    scratch = hs.init_table_scratch(capacity, dev)
    sk, sp = _clone(store), _clone(store)
    slots_k = hs.probe_insert(sk, scratch, capacity, base, khash, zeros64, reprs, zeros32, act)
    slots_p = hs.probe_insert_plain(sp, capacity, base, khash, zeros64, reprs, zeros32, act)
    _assert_equal(torch, "probe_insert[table].slots", slots_k, slots_p)
    for key in store:
        _assert_equal(torch, f"probe_insert[table].{key}", sk[key], sp[key])
    require(int(sk["overflow"]) == 0, "probe_insert[table]: overflow")
    vals = {c: (torch.from_numpy(_col_values(rng, d, n)).to(dev), torch.from_numpy(rng.random(n) > 0.05).to(dev))
            for c, d in JOIN_COLS}
    after_k2 = _clone(sk)
    uk, up = _clone(after_k2), _clone(after_k2)
    hs.table_upsert(uk, scratch, capacity, slots_k, act, delete, vals)
    hs.table_upsert_plain(up, capacity, slots_k, act, delete, vals)
    for key in store:
        _assert_equal(torch, f"table_upsert.{key}", uk[key], up[key])
    require(bool((scratch["last"] == -1).all()), "table_upsert: last-writer cells not clean")
    s_np, act_np, del_np = slots_k.cpu().numpy(), act.cpu().numpy(), dels
    live_rows = act_np & (s_np != capacity)
    last = np.full(capacity + 1, -1)
    np.maximum.at(last, s_np[live_rows], np.nonzero(live_rows)[0])
    winners = live_rows & (last[s_np] == np.arange(n))
    n_win, n_del = int(winners.sum()), int((winners & del_np).sum())
    # tombstones of absent keys claim a fresh slot (K2) and leave a grave
    absent = int((uk["grave"] & ~(store["occ"] | store["grave"])).sum())
    require(n_win < int(live_rows.sum()) and n_del > 0 and absent > 0,
            "table_upsert: data should hold duplicate keys, deletes and tombstones of absent keys")
    work = _clone(after_k2)
    rec = measure(torch, "table_upsert", lambda: hs.table_upsert(work, scratch, capacity, slots_k, act, delete, vals),
                  lambda: hs.table_upsert_plain(work, capacity, slots_k, act, delete, vals),
                  n * (4 + 1 + 1 + width) + n_win * width + n_del * 2 + width,
                  n * 10, reset=lambda: _restore(work, after_k2))
    recs["table_upsert"] = {"join": dict(rec, max_abs_err=0.0)}
    _report("2j", f"table_upsert ({n_win} winners of {int(live_rows.sum())} rows, {n_del} deletes, "
            f"{absent} graves of absent keys)", recs["table_upsert"]["join"])
    return recs


# ------------------------------------------------------------- phase 2s
SS_ROWS = 2048  # BASELINE #4's batch: min(2048, CAPACITY) (bench.py:630)
SS_RING = 1 << 14  # bench.py:631, each side's ring
SS_KEYS = 20_000  # bench.py:636
SS_STEP_MS = 2  # bench.py:642, a record every 2 ms
SS_WITHIN_MS = 10_000
SS_GRACE_MS = 1_000
SS_RETENTION_MS = 2 * SS_WITHIN_MS + SS_GRACE_MS
SS_PAD = 16  # padding rows at the end of phase 2s's batch


def _ss_bench_ts(rec, side, n):
    """ts of record ``rec`` of a side in bench.py's traffic (batches of
    ``n`` alternate left, right; a record every SS_STEP_MS)."""
    batch = 2 * (rec // n) + (side == "r")
    return TS0 + (batch * n + rec % n) * SS_STEP_MS


def _ss_ring_np(rng, ring, cursor, records, side, n, keys):
    """One side's ring after ``records`` records of bench.py's traffic, its
    cursor at ``cursor``: the last ``ring`` records at entry seq mod ring,
    live while within the side's retention, a quarter marked matched; the
    dump entry holds a record, not live.  Columns (BASELINE #4's plan): the
    left ring keeps L_ID and L_V, the right R_V, each the key (V = ID)."""
    b1 = ring + 1
    seq = np.arange(cursor - ring, cursor)
    pos = seq % ring
    st = {"ts": np.zeros(b1, np.int64), "krepr": np.zeros(b1, np.int64), "kval": np.zeros(b1, bool),
          "live": np.zeros(b1, bool), "matched": np.zeros(b1, bool), "seq": np.zeros(b1, np.int64)}
    ts = _ss_bench_ts(seq - cursor + records, side, n)
    kk = rng.integers(0, keys, ring)
    st["ts"][pos], st["krepr"][pos], st["kval"][pos], st["seq"][pos] = ts, kk, True, seq
    st["live"][pos] = ts + SS_RETENTION_MS >= ts.max()
    st["matched"][pos] = rng.random(ring) < 0.25
    st["ts"][ring], st["krepr"][ring], st["seq"][ring] = ts[0], kk[0], seq[0]
    cols = [(st["krepr"].copy(), st["kval"].copy()) for _ in range(2 if side == "l" else 1)]
    return st, cols, int(ts.max())


def make_ss_case(rng, ring=SS_RING, n=SS_ROWS, keys=SS_KEYS):
    """One BASELINE #4 step at its shapes, numpy: a left batch of ``n``
    rows (bench.py's next left batch: keys uniform over 20,000, 5% null
    keys, 2% of rows 30 s late, the last SS_PAD rows padding), the right
    ring it matches (after 3.5 rings of right records: entries past the
    retention are dead) and the left ring it is inserted into, whose
    cursor sits half a batch before a multiple of the ring (as rows not
    admitted earlier leave it), so the insert wraps it."""
    records = 7 * ring // 2  # each side's records so far
    ring_r, cols_r, smax_r = _ss_ring_np(rng, ring, records, records, "r", n, keys)
    l_cursor = 4 * ring - n // 2
    ring_l, cols_l, smax_l = _ss_ring_np(rng, ring, l_cursor, records, "l", n, keys)
    batch = 2 * (records // n)
    ts = TS0 + (batch * n + np.arange(n)) * SS_STEP_MS
    late = rng.random(n) < 0.02
    ts[late] -= 30_000
    row_keys = rng.integers(0, keys, n)
    kvalid = rng.random(n) > 0.05
    row_valid = np.arange(n) < n - SS_PAD
    row_keys[~row_valid], ts[~row_valid] = 0, 0
    rows = {"krepr": row_keys, "kvalid": kvalid & row_valid, "active": row_valid.copy(), "ts": ts,
            "row_valid": row_valid}
    # the batch's columns: L_ID (the key, null with it) and L_V (= ID)
    row_cols = [(row_keys.copy(), kvalid & row_valid), (row_keys.copy(), row_valid.copy())]
    return {"ring_l": ring_l, "cols_l": cols_l, "ring_r": ring_r, "cols_r": cols_r,
            "rows": rows, "row_cols": row_cols, "max_ts": smax_r, "smax_l": smax_l,
            "smax_r": smax_r, "cursor_l": l_cursor}


def ss_case_tensors(torch, case, dev):
    """``make_ss_case``'s arrays as tensors on ``dev`` (scalars 0-d)."""
    def t(x):
        return torch.from_numpy(np.asarray(x)).to(dev)

    out = {k: {f: t(v) for f, v in case[k].items()} for k in ("ring_l", "ring_r", "rows")}
    for k in ("cols_l", "cols_r", "row_cols"):
        out[k] = [(t(d), t(v)) for d, v in case[k]]
    for k in ("max_ts", "smax_l", "smax_r", "cursor_l"):
        out[k] = torch.tensor(case[k], dtype=torch.int64, device=dev)
    return out


def _clone_case(c):
    return {k: ({f: x.clone() for f, x in v.items()} if isinstance(v, dict)
                else [(d.clone(), m.clone()) for d, m in v] if isinstance(v, list) else v.clone())
            for k, v in c.items()}


def _assert_tree(torch, name, got, want):
    if isinstance(want, dict):
        for k in want:
            _assert_tree(torch, f"{name}.{k}", got[k], want[k])
    elif isinstance(want, (list, tuple)):
        require(len(got) == len(want), f"{name}: {len(got)} vs {len(want)} items")
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_tree(torch, f"{name}[{i}]", g, w)
    else:
        _assert_equal(torch, name, got, want)


def _ss_calls(torch, c, oc, plain=False):
    """Phase 2s's five calls (K10 count and write, K11 prologue and write,
    K12) on case ``c``, as BASELINE #4's plan makes them for a left batch
    (its key is L_ID, the batch's first column): the wrappers, or with
    ``plain`` their twins (which run on the card's tensors too)."""
    from ksql_tpu_torch.ops import ss_join as ssj

    def fn(name):
        return getattr(ssj, f"{name}_plain" if plain else name)

    r = c["rows"]
    key = c["row_cols"][0]

    def count():
        return fn("ss_match_count")("l", r["krepr"], r["kvalid"], r["active"], r["ts"], c["ring_r"],
                                    SS_WITHIN_MS, SS_WITHIN_MS)

    def write(cnt):
        return fn("ss_match")("l", r["krepr"], r["kvalid"], r["active"], r["ts"], c["ring_r"],
                              SS_WITHIN_MS, SS_WITHIN_MS, cnt, oc, c["row_cols"] + [key], c["cols_r"])

    def prologue(cnt):
        return fn("ss_insert_prologue")(r["row_valid"], r["ts"], r["active"], cnt[1], c["ring_l"],
                                        c["max_ts"], c["smax_l"], c["cursor_l"], pad_side=True,
                                        deferred=True, swin=SS_WITHIN_MS, grace=SS_GRACE_MS,
                                        retention=SS_RETENTION_MS)

    def insert(cnt, pro):
        fn("ss_insert")(c["ring_l"], c["cols_l"], pro, r["ts"], r["krepr"], r["kvalid"], cnt[1],
                        c["row_cols"], c["max_ts"], c["smax_l"], c["cursor_l"])

    def expire():
        return fn("ss_expire")({"l": c["ring_l"], "r": c["ring_r"]}, {"l": c["cols_l"], "r": c["cols_r"]},
                               c["max_ts"], {"l": c["smax_l"], "r": c["smax_r"]}, [torch.int64],
                               deferred=True, pad_sides={"l"}, after=SS_WITHIN_MS,
                               before=SS_WITHIN_MS, grace=SS_GRACE_MS, retention=SS_RETENTION_MS)

    return count, write, prologue, insert, expire


def check_ss_match(torch, kc, pc, oc):
    """K10's count and write on phase 2s's calls over case copies ``kc``
    (the wrappers) and ``pc`` (the twins): exact, the write's lanes and
    the ring's matched bits included, then each timed against its twin at
    the function's bytes and ops.  Leaves each copy's ring as one write
    leaves it.  Returns ``(count, twin's count, {mode: record}, info)``."""
    k_calls, p_calls = _ss_calls(torch, kc, oc), _ss_calls(torch, pc, oc, plain=True)
    got = k_calls[0]()
    want = p_calls[0]()
    for nm, g, w in zip(("cnt", "row_matched", "offsets", "total"), got, want):
        _assert_equal(torch, f"ss_match[count].{nm}", g, w)
    n, b1 = kc["rows"]["ts"].shape[0], kc["ring_r"]["ts"].shape[0]
    total = int(want[3])
    info = {"total": total, "rows_hit": int(want[1].sum()),
            "look": int((kc["rows"]["active"] & kc["rows"]["kvalid"]).sum()),
            "live": int((kc["ring_r"]["live"] & kc["ring_r"]["kval"]).sum())}
    require(0 < total < oc, f"ss_match: {total} matches")
    snap = kc["ring_r"]["matched"].clone()
    lanes_k = k_calls[1](got)
    lanes_p = p_calls[1](want)
    _assert_tree(torch, "ss_match[write]", lanes_k, lanes_p)
    _assert_equal(torch, "ss_match[write].matched", kc["ring_r"]["matched"], pc["ring_r"]["matched"])
    # the function's own work, as an index by key would do it: one key test
    # a row and an entry, a window test and a count a match (8 ops each)
    ops = (n + b1 + total) * 8
    # each input read once, each output written once: the rows' key, valid,
    # active and ts and the ring's match fields (18 B an entry); the count
    # writes cnt, row_matched, offsets and the total; the write also reads
    # the rows' offsets and counts and each match's entry, and writes oc
    # lanes of mi, mj, ts, ord_b, mvalid and the columns (data + valid)
    width = sum(d.element_size() + 1 for d, _v in kc["row_cols"][:1] + kc["row_cols"] + kc["cols_r"])
    recs = {"count": dict(measure(torch, "ss_match", k_calls[0], p_calls[0],
                                  n * (8 + 1 + 1 + 8) + b1 * 18 + n * (8 + 1 + 8) + 8, ops),
                          max_abs_err=0.0)}

    def reset():
        for c in (kc, pc):
            c["ring_r"]["matched"].copy_(snap)

    recs["write"] = dict(measure(
        torch, "ss_match", lambda: k_calls[1](got), lambda: p_calls[1](want),
        n * (8 + 1 + 1 + 8 + 8 + 8) + b1 * 18 + total * (8 + 1) + oc * (4 + 4 + 8 + 8 + 1 + width), ops,
        reset=reset), max_abs_err=0.0)
    # the timing runs reset both copies: write them once more
    reset()
    k_calls[1](got)
    p_calls[1](want)
    return got, want, recs, info


def phase_ss_kernels(torch, seed, ring=SS_RING, n=SS_ROWS):
    """BASELINE #4's kernels against their twins at its shapes: a
    2,048-row left batch (5% null keys, 2% late rows, 16 padding rows)
    against a 16,385-entry right ring filled from bench.py's traffic, with
    its dead entries, and into a left ring whose cursor wraps.  K10 count
    and write, K11 prologue and write, K12; everything exact, the dump
    entries included.  Returns ``{kernel: {mode: record}}``."""
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(seed + 30)
    base = ss_case_tensors(torch, make_ss_case(rng, ring, n), dev)
    oc = 8 * n  # bench.py:633, ss_out_capacity=8 * cap
    b1 = ring + 1
    recs: dict = {}
    kc, pc = _clone_case(base), _clone_case(base)
    k_calls, p_calls = _ss_calls(torch, kc, oc), _ss_calls(torch, pc, oc, plain=True)

    # ---- K10 count and write (each on its own copy of the right ring)
    got, want, recs["ss_match"], info = check_ss_match(torch, kc, pc, oc)
    total, rows_hit = info["total"], info["rows_hit"]
    for mode, what in (("count", f"{total} matches of {info['look']} rows x {b1} entries, {info['live']} "
                                 "live entries; no single PyTorch call computes it"),
                       ("write", f"{total} matches into {oc} lanes, {rows_hit} rows walked; no single "
                                 "PyTorch call")):
        _report("2s", f"ss_match[{mode}] ({what})", recs["ss_match"][mode])

    # ---- K11 prologue
    pro_k = k_calls[2](got)
    pro_p = p_calls[2](want)
    _assert_tree(torch, "ss_insert[prologue]", pro_k, pro_p)
    lost, admitted = int(pro_p["scal"][0]), int(pro_p["scal"][1])
    n_pad = int(pro_p["pad"].sum())
    require(lost == 0 and admitted < n - SS_PAD, f"ss_insert: lost {lost}, {admitted} admitted")
    rec = measure(torch, "ss_insert", lambda: k_calls[2](got), lambda: p_calls[2](want),
                  n * (1 + 8 + 1 + 1) + admitted * 9 + 24 + n * (1 + 1 + 8 + 4) + 40, n * 30)
    recs["ss_insert"] = {"prologue": dict(rec, max_abs_err=0.0)}
    _report("2s", f"ss_insert[prologue] ({admitted} of {n - SS_PAD} rows admitted, {n_pad} pads on "
            "arrival; no single PyTorch call)", recs["ss_insert"]["prologue"])

    # ---- K11 write
    snap_k, snap_p = _clone_case(kc), _clone_case(pc)
    k_calls[3](got, pro_k)
    p_calls[3](want, pro_p)
    for k in ("ring_l", "cols_l", "cursor_l", "max_ts", "smax_l"):
        _assert_tree(torch, f"ss_insert[write].{k}", kc[k], pc[k])

    def reset_insert():
        for c, snap in ((kc, snap_k), (pc, snap_p)):
            for k in ("ring_l", "cols_l", "cursor_l", "max_ts", "smax_l"):
                _restore_tree(c[k], snap[k])

    rec = measure(torch, "ss_insert", lambda: k_calls[3](got, pro_k),
                  lambda: p_calls[3](want, pro_p),
                  n * (8 + 8 + 1 + 1 + 1 + 1 + 8 + 4 + 2 * 9) + 40 + admitted * (8 + 8 + 1 + 1 + 1 + 8 + 2 * 9) + 24,
                  n * 10, reset=reset_insert)
    recs["ss_insert"]["write"] = dict(rec, max_abs_err=0.0)
    reset_insert()
    k_calls[3](got, pro_k)
    p_calls[3](want, pro_p)
    _report("2s", f"ss_insert[write] ({admitted} rows, the cursor wraps the ring; no single PyTorch "
            "call)", recs["ss_insert"]["write"])

    # ---- K12 over both rings after the step, the clock 6 s on
    for c in (kc, pc):
        c["max_ts"].add_(6_000)
    snap_k, snap_p = _clone_case(kc), _clone_case(pc)
    out_k = k_calls[4]()
    out_p = p_calls[4]()
    _assert_tree(torch, "ss_expire", out_k, out_p)
    for k in ("ring_l", "ring_r"):
        _assert_tree(torch, f"ss_expire.{k}", kc[k], pc[k])
    n_emit = int(out_p["mask"].sum())
    require(n_emit > 0, "ss_expire: nothing closed")

    def reset_expire():
        for c, snap in ((kc, snap_k), (pc, snap_p)):
            for k in ("ring_l", "ring_r"):
                _restore_tree(c[k], snap[k])

    rec = measure(torch, "ss_expire", k_calls[4], p_calls[4],
                  2 * b1 * (8 + 8 + 1 + 1 + 1 + 8) + 3 * b1 * 9 + 24 + 2 * b1 * (1 + 1)
                  + 2 * b1 * (1 + 8 + 8 + 8 + 1 + 3 * 9), 2 * b1 * 12, reset=reset_expire)
    recs["ss_expire"] = {"ss": dict(rec, max_abs_err=0.0)}
    _report("2s", f"ss_expire ({n_emit} deferred pads of {2 * b1} entries; no single PyTorch call)",
            recs["ss_expire"]["ss"])
    return recs


def _restore_tree(dst, src):
    if isinstance(dst, dict):
        for k in dst:
            _restore_tree(dst[k], src[k])
    elif isinstance(dst, list):
        for (d, m), (sd, sm) in zip(dst, src):
            d.copy_(sd)
            m.copy_(sm)
    else:
        dst.copy_(src)


# ------------------------------------------------------------- phase 3/4
def produce_pageviews(broker, url_idx, ts, user_ids=None):
    from ksql_tpu_torch.runtime.topics import Record

    topic = broker.create_topic("page_views")
    uids = (url_idx % 1000 if user_ids is None else user_ids).tolist()
    for u, t, uid in zip(url_idx.tolist(), ts.tolist(), uids):
        value = f'{{"URL":"/page/{u}","USER_ID":{uid},"VIEWTIME":{t}}}'
        topic.produce(Record(key=None, value=value, timestamp=t))


def sink_records(broker, topic="PV_COUNTS"):
    return [(r.key, r.value, r.timestamp, r.window) for r in broker.topic(topic).all_records()]


def check_counts(broker, url_idx, ts, label):
    expected = {}
    for u, t in zip(url_idx.tolist(), ts.tolist()):
        k = (f"/page/{u}", t - t % HOUR_MS)
        expected[k] = expected.get(k, 0) + 1
    last = {}
    for key, value, _ts, window in sink_records(broker):
        last[(key, window[0])] = json.loads(value)["CNT"]
    require(last == expected, f"{label}: final counts differ from the dict reference "
            f"({len(last)} sink keys vs {len(expected)} expected)")
    return len(expected)


#: the kernels each main-path phase must launch, with the mode (None: the
#: kernel has one) its route runs them in; a phase may launch no other
_TUMBLING = {"row_prologue": "tumbling", "probe_insert": None, "fold_and_mark": "fold",
             "combine_windows": "gather"}
_SLICED = {"row_prologue": "sliced", "probe_insert": None, "sliced_fold": None,
           "member_lanes": None, "combine_windows": "sliced", "evict": "sliced"}
#: a stream-table join: K8 per stream batch; K1 (table mode), K2 and K9 per
#: table batch
_JOIN = {"probe_find": "join", "row_prologue": "table", "probe_insert": None, "table_upsert": "join"}
#: a stream-stream join: K10 and K11 in both modes per batch, K12 per tick
_SS = {"ss_match": ("count", "write"), "ss_insert": ("prologue", "write"), "ss_expire": None}
#: a session aggregation: K1's session mode, K13 twice, K14 in its three
#: modes, K15, K16 delete, K2 and K16 write per batch
_SESSION = {"row_prologue": "session", "seg_sort": None,
            "session_items": ("prologue", "first", "items"), "session_merge": "merge",
            "session_write": ("delete", "write"), "probe_insert": None}
#: EMIT FINAL: K1 without its grace cut, K17, K2, K3 and K18 per batch; K6
#: gathers the windows a batch or the flush closes
_FINAL = {"row_prologue": "tumbling", "suppress_clock": "tumbling", "probe_insert": None,
          "fold_and_mark": "fold", "suppress_close": None, "combine_windows": "gather"}
#: HAVING retraction: the tumbling path, and K19 per batch
_HAVING = {**_TUMBLING, "having_verdict": None}
#: vector aggregates: the tumbling path with K6 gathering the width-K state,
#: K13 for the vector orders, and K4 at each grow's retention pass
_VECTOR = {**_TUMBLING, "combine_windows": "wide", "seg_sort": None, "evict": "tumbling"}
#: a table aggregation: per side K1 (unwindowed), K3 and K6; K8's find mode
#: on the undo side, K2 on the apply side
_TABLE_AGG = {"row_prologue": "tumbling", "probe_find": "find", "probe_insert": None,
              "fold_and_mark": "fold", "combine_windows": "gather"}
#: a table-table join: K1's table mode, K2, K8's gather mode, K9's side mode
_TT = {"row_prologue": "table", "probe_insert": None, "probe_find": "gather", "table_upsert": "side"}
PATH_KERNELS = {
    "3": _TUMBLING,
    "4": {**_TUMBLING, "evict": "tumbling"},
    "6": _SLICED,
    "7": _SLICED,
    "8": {**_TUMBLING, "row_prologue": "expansion"},
    "9": _JOIN,
    "9g": _JOIN,
    "10": _SS,
    "10g": _SS,
    "11": _SESSION,
    "11g": _SESSION,
    "12": _FINAL,
    "12g": {**_FINAL, "evict": "suppress"},
    "12h": {**_FINAL, "row_prologue": "expansion", "suppress_clock": "expansion"},
    "13": _HAVING,
    "13r": _HAVING,
    "14": {**_VECTOR, "vec_collect": ("append", "set", "ring"), "vec_topk": ("plain", "distinct")},
    "14h": {**_VECTOR, "vec_collect": "hist", "vec_hist": None},
    "15": _TABLE_AGG,
    # COLLECT_LIST and HISTOGRAM: K23 before K20 on the undo side, K20
    # (append, hist) and K22 on both, K13 for K20's orders, K6's wide gather
    "16": {**_TABLE_AGG, "combine_windows": "wide", "seg_sort": None,
           "vec_collect": ("append", "hist"), "vec_hist": None, "vec_remove": None},
    # a table transform: expression ops only, no kernel
    "17": {},
    # a table-table join: per single-side batch K1's table mode, K2, K8's
    # gather of the other side and K9's side mode
    "18": _TT,
    "18g": _TT,
    # a foreign-key join, one change a step: a left change K1, K2, K8's live
    # mode (one launch for the new and the old foreign key) and K9's side
    # mode; a right change K1, K2, K9's side mode and K24's fan-out (one
    # launch); phase_orders_enriched holds K8 live to one launch a left
    # step and K24 to one a right step
    "19": {"row_prologue": "table", "probe_insert": None, "probe_find": "live", "table_upsert": "side",
           "fk_fanout": None},
    # push taps: the identity pipeline (standalone, per record) and the
    # stateless upstream (listener) launch no kernel; K25 per family a span
    "20": {"tap_residual": None},
    "21": {"tap_residual": None},
    # the offsets: K3's fold, then its argset mode for the payloads
    "22": {**_TUMBLING, "fold_and_mark": ("fold", "argset")},
    "23": {**_TUMBLING, "fold_and_mark": ("fold", "argset")},
    # ... with K1's expansion mode (the offsets do not slice)
    "23h": {**_TUMBLING, "row_prologue": "expansion", "fold_and_mark": ("fold", "argset")},
    # a session aggregation with K15's argset mode
    "23s": {**_SESSION, "session_merge": "argset"},
}
#: per phase, each kernel's launches in that phase's card run, by mode
PATH_LAUNCHES: dict = {}


def _wrappers():
    from ksql_tpu_torch.ops import hash_store as hs
    from ksql_tpu_torch.ops import session
    from ksql_tpu_torch.ops import slicing
    from ksql_tpu_torch.ops import ss_join
    from ksql_tpu_torch.ops import suppress
    from ksql_tpu_torch.ops import table_join
    from ksql_tpu_torch.ops import tap_residual
    from ksql_tpu_torch.ops import vector

    return (hs.KERNEL_WRAPPERS + slicing.KERNEL_WRAPPERS + ss_join.KERNEL_WRAPPERS
            + session.KERNEL_WRAPPERS + suppress.KERNEL_WRAPPERS + vector.KERNEL_WRAPPERS
            + table_join.KERNEL_WRAPPERS + tap_residual.KERNEL_WRAPPERS)


def zero_launches() -> None:
    for w in _wrappers():
        w.launches = 0
        for m in getattr(w, "mode_launches", {}):
            w.mode_launches[m] = 0


def read_launches() -> dict:
    """Each kernel's launches since :func:`zero_launches`, by mode (one
    ``all`` entry for a kernel with one mode)."""
    out = {}
    for w in _wrappers():
        modes = dict(getattr(w, "mode_launches", {}))
        if modes:
            require(sum(modes.values()) == w.launches,
                    f"{w.__name__}: mode counts {modes} do not add up to {w.launches}")
        out[w.__name__] = modes or {"all": w.launches}
    return out


def check_path_launches(path: str, launches: dict) -> None:
    for name, modes in PATH_KERNELS[path].items():
        for mode in modes if isinstance(modes, tuple) else (modes,):
            got = launches[name]["all" if mode is None else mode]
            require(got > 0, f"[{path}] kernel {name}{'' if mode is None else f'[{mode}]'} "
                    f"was not launched on this path's run ({launches[name]})")
    listed = {(k, m) for k, ms in PATH_KERNELS[path].items()
              for m in (ms if isinstance(ms, tuple) else ("all" if ms is None else ms,))}
    other = {f"{k}[{m}]": c for k, modes in launches.items() for m, c in modes.items()
             if c and (k, m) not in listed}
    require(not other, f"[{path}] launched kernels or modes outside its list: {other}")
    print(f"[{path}] launches on this path's card run: {json.dumps(launches)}")


def _timed_batches(torch, batch_seconds):
    """Patch the executor's stream batch to append its synchronized wall
    seconds to ``batch_seconds``; returns the undo."""
    from ksql_tpu_torch.runtime.device_executor import TorchDeviceExecutor

    run_batch = TorchDeviceExecutor._run_batch

    def timed_batch(self):
        t0 = time.perf_counter()
        out = run_batch(self)
        torch.cuda.synchronize()
        batch_seconds.append(time.perf_counter() - t0)
        return out

    TorchDeviceExecutor._run_batch = timed_batch
    return lambda: setattr(TorchDeviceExecutor, "_run_batch", run_batch)


def run_main_path(torch, plan_json, url_idx, ts, device, store, batch_seconds=None, rows=None,
                  user_ids=None, path=None, finish=None, **run_kw):
    """``run_plan`` over freshly produced page-view records (``run_kw``:
    ``sliced``), then ``finish(executor)`` when given (an EMIT FINAL
    query's ``flush_time``).  With a ``batch_seconds`` list, each
    micro-batch (assembly, encode, device step, emit decode, produce) is
    timed on the host clock up to a ``torch.cuda.synchronize()``.  With a
    ``path`` (a phase of ``PATH_KERNELS``), the launch counts are set to 0
    just before ``run_plan`` and read just after it (and ``finish``) into
    ``PATH_LAUNCHES[path]``, and every kernel of the path must have
    launched."""
    from ksql_tpu_torch.runner import run_plan
    from ksql_tpu_torch.runtime.topics import Broker

    broker = Broker()
    produce_pageviews(broker, url_idx, ts, user_ids)
    undo = _timed_batches(torch, batch_seconds) if batch_seconds is not None else (lambda: None)
    try:
        if path is not None:
            zero_launches()
        t0 = time.perf_counter()
        ex = run_plan(plan_json, broker, device=device, capacity=rows or N_ROWS,
                      store_capacity=store, **run_kw)
        if finish is not None:
            finish(ex)
        if device != "cpu":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        undo()
    if path is not None:
        PATH_LAUNCHES[path] = read_launches()
        check_path_launches(path, PATH_LAUNCHES[path])
    return broker, ex, secs


def phase_e2e(torch, plan_json, seed):
    rng = np.random.default_rng(seed + 1)
    n = FLAGSHIP_BATCHES * N_ROWS
    url_idx = rng.zipf(1.3, size=n).astype(np.int64) % N_URLS
    ts = TS0 + np.arange(n, dtype=np.int64) * 17
    torch.cuda.reset_peak_memory_stats()
    batch_s = []
    broker, ex, secs = run_main_path(torch, plan_json, url_idx, ts, DEVICE, STORE, batch_s, path="3")
    peak = torch.cuda.max_memory_allocated()
    require(int(ex.query.state["overflow"]) == 0, "e2e: store overflowed")
    keys = check_counts(broker, url_idx, ts, "e2e")
    cpu_broker, _ex, cpu_secs = run_main_path(torch, plan_json, url_idx, ts, "cpu", STORE)
    require(sink_records(broker) == sink_records(cpu_broker), "e2e: card sink differs from the CPU run")
    p50, p99 = np.percentile(np.array(batch_s) * 1e3, [50, 99])
    print(f"[3] e2e flagship: {n} events, {keys} (URL, window) keys, {len(sink_records(broker))} sink records; "
          f"card run {secs:.3f} s = {n / secs:.1f} events/s; batch p50 {p50:.3f} ms p99 {p99:.3f} ms "
          f"over {len(batch_s)} batches; peak device memory {peak} B; CPU twin run {cpu_secs:.3f} s; "
          "sink equals CPU run, counts equal dict reference, overflow 0")
    return dict(events_per_s=n / secs, p50_ms=p50, p99_ms=p99, peak_bytes=peak)


def phase_breakdown(torch, drive, n_batches, tag):
    """Where an e2e batch's time goes, over ``drive()`` (a run of a few
    stream batches through the runner, returning its wall seconds): host
    stages timed by wrapping the port's functions (each device step and
    table step synchronized, so its device work is charged to it — the
    pipelined overlap is off here), and the card's busy time from
    torch.profiler (kernels and copies) against the wall time."""
    from torch.profiler import ProfilerActivity, profile

    from ksql_tpu_torch.common.batch import HostBatch
    from ksql_tpu_torch.runtime import device_executor
    from ksql_tpu_torch.runtime.device import BatchLayout
    from ksql_tpu_torch.runtime.lowering import TorchCompiledQuery
    from ksql_tpu_torch.runtime.sink import SinkWriter

    acc: dict = {}

    def timed(stage, fn, sync=False):
        def wrapper(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            if sync:
                torch.cuda.synchronize()
            label = stage(*a, **k) if callable(stage) else stage
            acc[label] = acc.get(label, 0.0) + time.perf_counter() - t0
            return out
        return wrapper

    patches = [
        (device_executor, "decode_source_record", "json decode", False),
        (BatchLayout, "encode", "encode", False),
        (TorchCompiledQuery, "upload", "upload", True),
        (TorchCompiledQuery, "_step", "device step", True),
        (TorchCompiledQuery, "_table_step", "table step", True),
        (TorchCompiledQuery, "_ss_prepare", "ss match count + insert prologue", True),
        (TorchCompiledQuery, "_ss_write", "ss match + insert write + emission", True),
        (TorchCompiledQuery, "_ss_expire", "ss expiry", True),
        (TorchCompiledQuery, "_read_sess_ovf", "of which the sess_ovf read", False),
        (TorchCompiledQuery, "_ta_side",
         lambda self, arrays, undo: "undo side" if undo else "apply side", True),
        (TorchCompiledQuery, "_react_to_load", "load check", False),
        (TorchCompiledQuery, "_tt_step", "tt step", True),
        (TorchCompiledQuery, "_fk_left", "fk left step", True),
        (TorchCompiledQuery, "_fk_right", "fk right step", True),
        (TorchCompiledQuery, "_decode_emits", "emit decode", False),
        (SinkWriter, "produce", "sink produce", False),
    ]
    saved = [(obj, name, obj.__dict__[name]) for obj, name, _s, _y in patches]
    saved.append((HostBatch, "from_rows", HostBatch.__dict__["from_rows"]))
    try:
        for obj, name, stage, sync in patches:
            setattr(obj, name, timed(stage, getattr(obj, name), sync))
        HostBatch.from_rows = staticmethod(timed("batch assembly", HostBatch.from_rows))
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            wall = drive()
    finally:
        for obj, name, orig in saved:
            setattr(obj, name, orig)
    busy = sum(_device_us(e) for e in prof.key_averages()) / 1e6
    per = {k: v / n_batches * 1e3 for k, v in sorted(acc.items(), key=lambda kv: -kv[1])}
    # a stage named "of which ..." runs inside another (the device step)
    per["other host"] = wall / n_batches * 1e3 - sum(v for k, v in per.items()
                                                     if not k.startswith("of which"))
    print(f"[{tag}] breakdown over {n_batches} batches (ms per batch): "
          + ", ".join(f"{k} {v:.2f}" for k, v in per.items())
          + f"; card busy {busy / wall * 100:.2f}% of {wall:.3f} s wall (idle {100 - busy / wall * 100:.2f}%)")
    return {"ms_per_batch": per, "device_busy_share": busy / wall}


def phase_growth(torch, plan_json, seed):
    """High-cardinality growth through the load trigger.  Batches of
    GROWTH_ROWS rows give the pipelined trigger (occupancy + 4 batches of
    headroom > 0.75 x capacity) room to fire while the 2^20-slot store is
    about 0.3 full: the reference's 32-probe limit loses rows from about
    0.47 load at 65,536-row batches (see PERF.md), so the store must grow
    before that.  Each hour of event time has its own pool of URLs, each
    viewed GROWTH_REPEATS times on average, so a batch adds ~3% of the
    store in new (URL, window) keys; the trigger passes at the drain's
    check, over the last batch's ~320,000 keys."""
    rng = np.random.default_rng(seed + 2)
    n = GROWTH_BATCHES * GROWTH_ROWS
    ts = TS0 - TS0 % HOUR_MS + (np.arange(n, dtype=np.int64) * (48 * HOUR_MS)) // n
    hour = (ts - ts[0]) // HOUR_MS
    pool = max(1, n // 48 // GROWTH_REPEATS)
    url_idx = hour * pool + rng.integers(0, pool, n)
    torch.cuda.reset_peak_memory_stats()
    broker, ex, secs = run_main_path(torch, plan_json, url_idx, ts, DEVICE, STORE, rows=GROWTH_ROWS,
                                     path="4")
    q = ex.query
    require(q.evictions >= 1, "growth: the retention pass never ran")
    require(q.grows >= 1 and q.store_capacity == 2 * STORE, f"growth: store at {q.store_capacity} slots")
    require(int(q.state["overflow"]) == 0, "growth: store overflowed")
    keys = check_counts(broker, url_idx, ts, "growth")
    print(f"[4] growth: {n} events in batches of {GROWTH_ROWS}, {len(np.unique(url_idx))} URLs, "
          f"{keys} keys in {secs:.3f} s; {q.evictions} retention passes, {q.compactions} compactions, "
          f"{q.grows} grows -> {q.store_capacity} slots; host rebuild seconds "
          f"{[round(x, 4) for x in q.rebuild_seconds]} (the last one is the grow); peak device memory "
          f"{torch.cuda.max_memory_allocated()} B; counts equal dict reference, overflow 0")


# ------------------------------------------------------------- phase 6-8
HOP_BATCHES = 8  # phases 6, 8 and 12h, cut from 16 for the script's time (PERF.md §4)
LONG_BATCHES = 72  # past EVICT_INTERVAL (64): the cadence retention pass runs
LONG_ROWS = 8192  # phase 7's batch, cut from 16,384 for the script's time (PERF.md §4)
HOT_URLS = 500
POOL_URLS = 2000


def hop_traffic(seed, n_batches=HOP_BATCHES):
    """``bench.py:119-146`` at BASELINE #2's batch: 50,000 URLs drawn
    zipf(1.3), USER_ID uniform in 1..999, records 17 ms apart."""
    rng = np.random.default_rng(seed + 3)
    n = n_batches * HOP_ROWS
    url_idx = rng.zipf(1.3, size=n).astype(np.int64) % N_URLS
    return url_idx, rng.integers(1, 1000, n), TS0 + np.arange(n, dtype=np.int64) * 17


def hop_reference(url_idx, uid, ts, size=HOUR_MS, adv=15 * 60_000):
    """SUM/AVG/MIN/MAX of USER_ID per (URL, hopping window), by numpy."""
    k = -(-size // adv)
    first = ts - ts % adv
    starts = np.concatenate([first - h * adv for h in range(k)])
    urls, uids, tts = np.tile(url_idx, k), np.tile(uid, k), np.tile(ts, k)
    keep = (starts >= 0) & (starts + size > tts)
    urls, uids, starts = urls[keep], uids[keep], starts[keep]
    order = np.lexsort((starts, urls))
    urls, uids, starts = urls[order], uids[order], starts[order]
    head = np.ones(urls.size, bool)
    head[1:] = (urls[1:] != urls[:-1]) | (starts[1:] != starts[:-1])
    idx = np.nonzero(head)[0]
    sums = np.add.reduceat(uids, idx)
    cnts = np.diff(np.append(idx, urls.size))
    mins = np.minimum.reduceat(uids, idx)
    maxs = np.maximum.reduceat(uids, idx)
    return {(f"/page/{u}", int(w)): (int(sm), float(np.float64(sm) / c), int(mn), int(mx))
            for u, w, sm, c, mn, mx in zip(urls[idx].tolist(), starts[idx].tolist(),
                                           sums.tolist(), cnts.tolist(), mins.tolist(), maxs.tolist())}


def last_hop_values(broker):
    last = {}
    for key, value, _ts, window in sink_records(broker, "PV_STATS"):
        v = json.loads(value)
        last[(key, window[0])] = (v["S"], v["A"], v["MN"], v["MX"])
    return last


def check_hop_values(broker, url_idx, uid, ts, label):
    last = last_hop_values(broker)
    want = hop_reference(url_idx, uid, ts)
    require(last == want, f"{label}: final SUM/AVG/MIN/MAX differ from the dict reference "
            f"({len(last)} sink keys vs {len(want)} expected, "
            f"{sum(last.get(k) != v for k, v in want.items())} differ)")
    return last


def phase_hop_e2e(torch, plan_json, seed, sliced, tag):
    """BASELINE #2 end to end through ``run_plan``: the sliced route
    (``sliced=None``) or the k-fold expansion (``sliced=False``)."""
    url_idx, uid, ts = hop_traffic(seed)
    n = url_idx.size
    torch.cuda.reset_peak_memory_stats()
    batch_s = []
    broker, ex, secs = run_main_path(torch, plan_json, url_idx, ts, DEVICE, STORE, batch_s,
                                     rows=HOP_ROWS, user_ids=uid, path=tag, sliced=sliced)
    peak = torch.cuda.max_memory_allocated()
    q = ex.query
    if sliced is None:
        require(q.sliced and q.slice_ring == HOP_RING and q.hop_k == 4,
                f"{tag}: route sliced={q.sliced} ring={q.slice_ring} k={q.hop_k}")
    else:
        require(not q.sliced and q.expansion == 4 and q.windowing_fallback is not None,
                f"{tag}: expected the expansion route")
    require(int(q.state["overflow"]) == 0, f"{tag}: store overflowed")
    last = check_hop_values(broker, url_idx, uid, ts, tag)
    cpu_broker, _ex, cpu_secs = run_main_path(torch, plan_json, url_idx, ts, "cpu", STORE,
                                              rows=HOP_ROWS, user_ids=uid, sliced=sliced)
    require(sink_records(broker, "PV_STATS") == sink_records(cpu_broker, "PV_STATS"),
            f"{tag}: card sink differs from the CPU run")
    p50, p99 = np.percentile(np.array(batch_s) * 1e3, [50, 99])
    print(f"[{tag}] BASELINE #2 {'sliced' if q.sliced else 'expansion'}: {n} events, "
          f"{len(last)} (URL, window) keys, {len(sink_records(broker, 'PV_STATS'))} sink records; "
          f"card run {secs:.3f} s = {n / secs:.1f} events/s; batch p50 {p50:.3f} ms p99 {p99:.3f} ms "
          f"over {len(batch_s)} batches; store {q.store_capacity} slots after {q.grows} grows "
          f"(rebuild s {[round(x, 4) for x in q.rebuild_seconds]}); peak device memory {peak} B; "
          f"CPU twin run {cpu_secs:.3f} s; sink equals CPU run, values equal dict reference, overflow 0")
    return last, dict(events_per_s=n / secs, p50_ms=p50, p99_ms=p99, peak_bytes=peak,
                      grows=q.grows, store_slots=q.store_capacity)


def phase_hop_long(torch, plan_json, seed):
    """72 x 8,192 records over 48 h (a batch spans 40 min): 500 hot URLs in
    every hour, so their ring cells wrap after 25.5 h, and an hour-local
    pool of 2,000 URLs per hour that goes cold and passes the 25 h
    retention.  The ring must be resized (more than 25 h of event time
    live), the store must grow, and the cadence retention pass at batch
    64 (~42.7 h) must free the cold pools' keys."""
    from ksql_tpu_torch.runtime.lowering import TorchCompiledQuery

    rng = np.random.default_rng(seed + 4)
    n = LONG_BATCHES * LONG_ROWS
    ts = TS0 - TS0 % HOUR_MS + (np.arange(n, dtype=np.int64) * (48 * HOUR_MS)) // n
    hour = (ts - ts[0]) // HOUR_MS
    hot = rng.random(n) < 0.25
    url_idx = np.where(hot, rng.integers(0, HOT_URLS, n),
                       HOT_URLS + hour * POOL_URLS + rng.integers(0, POOL_URLS, n))
    uid = rng.integers(1, 1000, n)
    freed = []
    evict = TorchCompiledQuery._evict

    def counting_evict(self):
        before = int(self.state["occ"].sum())
        evict(self)
        freed.append(before - int(self.state["occ"].sum()))

    TorchCompiledQuery._evict = counting_evict
    try:
        torch.cuda.reset_peak_memory_stats()
        broker, ex, secs = run_main_path(torch, plan_json, url_idx, ts, DEVICE, STORE,
                                         rows=LONG_ROWS, user_ids=uid, path="7")
    finally:
        TorchCompiledQuery._evict = evict
    q = ex.query
    require(q.sliced, "long span: expected the sliced route")
    require(q.evictions >= 1 and max(freed) > 0, f"long span: no retention pass freed keys ({freed})")
    require(q.ring_resizes >= 1, f"long span: the ring was never resized (ring {q.slice_ring})")
    require(q.grows >= 1, "long span: the store never grew")
    require(int(q.state["overflow"]) == 0, "long span: store overflowed")
    last = check_hop_values(broker, url_idx, uid, ts, "long span")
    print(f"[7] hopping long span: {n} events over 48 h in {secs:.3f} s = {n / secs:.1f} events/s; "
          f"{len(last)} (URL, window) keys; {q.evictions} retention passes freeing {freed} keys; "
          f"{q.compactions} compactions, {q.grows} grows -> {q.store_capacity} slots "
          f"(rebuild s {[round(x, 4) for x in q.rebuild_seconds]}); {q.ring_resizes} ring regrows -> "
          f"{q.slice_ring} slices (regrow s {[round(x, 4) for x in q.ring_seconds]}); peak device "
          f"memory {torch.cuda.max_memory_allocated()} B; values equal dict reference, overflow 0")
    return dict(events_per_s=n / secs, freed=freed, grows=q.grows, store_slots=q.store_capacity,
                ring=q.slice_ring, ring_seconds=q.ring_seconds, rebuild_seconds=q.rebuild_seconds)


# ------------------------------------------------------------- phase 9
JOIN_BATCHES = 4  # cut from 16, then 8, to keep the whole script inside its time (PERF.md §4)
#: the second part: stream batches with USERS changes before every
#: JOIN_CHANGE_EVERY-th (cut from 8 batches, a change before every fourth)
JOIN_CHANGE_BATCHES = 2  # cut from 4 for the script's time
JOIN_CHANGE_EVERY = 2
JOIN_CHANGES = 4096
#: phase 9g: users arrive in ticks of GROW_TICK records into a table store
#: of GROW_STORE slots, which doubles four times to JOIN_STORE (sizes and
#: why in PERF.md; scripts/torch_store_overflow.py --table counts the overflow)
GROW_TICK = 4096
GROW_STORE = 1 << 14


def produce_users(broker, ids, regions, ts):
    """USERS changelog records: key = ID, value NAME/REGION (``None``
    region: null; ``False``: a tombstone)."""
    from ksql_tpu_torch.runtime.topics import Record

    topic = broker.create_topic("users")
    for k, region in zip(ids, regions):
        if region is False:
            value = None
        elif region is None:
            value = f'{{"NAME":"user{k}","REGION":null}}'
        else:
            value = f'{{"NAME":"user{k}","REGION":"{region}"}}'
        topic.produce(Record(key=k, value=value, timestamp=ts))


def produce_clicks(broker, uid, ts):
    from ksql_tpu_torch.runtime.topics import Record

    topic = broker.create_topic("clicks")
    for u, t in zip(uid.tolist(), ts.tolist()):
        topic.produce(Record(key=None, value=f'{{"USER_ID":{u},"URL":"/u/{u % 997}"}}', timestamp=t))


def dict_join(users, uid, ts):
    """ENRICHED by a plain dict: a click emits (USER_ID, URL, REGION, ts)
    when its user is in the table with a region other than 'excluded'
    (LEFT JOIN, then WHERE U.REGION <> 'excluded', which a null region
    fails)."""
    out = []
    for u, t in zip(uid.tolist(), ts.tolist()):
        region = users.get(u)
        if region is not None and region != "excluded":
            out.append((u, f"/u/{u % 997}", region, t))
    return out


def enriched_sink(broker):
    out = []
    for r in broker.topic("ENRICHED").all_records():
        v = json.loads(r.value)
        out.append((r.key, v["URL"], v["REGION"], r.timestamp))
    return out


def user_changes(rng, users, n, next_key):
    """``n`` USERS changes, applied to ``users`` in order: a third each
    tombstones (of present keys, some absent), new keys and updates of a
    present key's region, a fifth of those to 'excluded'.  Returns (ids,
    regions, next new key)."""
    present = np.fromiter(users.keys(), np.int64, len(users))
    ids, regions = [], []
    for kind, pick in zip(rng.integers(0, 3, n).tolist(), rng.integers(0, present.size, n).tolist()):
        if kind == 0:
            k = int(present[pick]) if rng.random() > 0.1 else int(next_key + 10**6)
            region = False
            users.pop(k, None)
        elif kind == 1:
            k, next_key = next_key, next_key + 1
            region = f"r{k % N_REGIONS}"
            users[k] = region
        else:
            k = int(present[pick])
            region = "excluded" if rng.random() < 0.2 else f"r{int(rng.integers(0, N_REGIONS))}"
            users[k] = region
        ids.append(k)
        regions.append(region)
    return ids, regions, next_key


def phase_join_e2e(torch, plan_json, seed):
    """BASELINE #3 end to end through ``start_plan``/``run_until_quiescent``
    at ``bench.py:534``'s widths: 100,000 USERS (REGION r{k % 50}) into a
    2^18-slot table store, then JOIN_BATCHES (4) x 65,536 CLICKS (USER_ID
    uniform in 0..199,999, URL /u/{uid % 997}); then JOIN_CHANGE_BATCHES
    (4) more stream batches with 4,096 USERS changes before every second.  The
    sink must equal a dict join replayed in the executor's order, record
    for record, and nothing may overflow."""
    from ksql_tpu_torch.runner import run_until_quiescent, start_plan
    from ksql_tpu_torch.runtime.topics import Broker

    n_batches, change_batches, path = JOIN_BATCHES, JOIN_CHANGE_BATCHES, "9"
    rng = np.random.default_rng(seed + 5)
    broker = Broker()
    users = {k: f"r{k % N_REGIONS}" for k in range(JOIN_USERS)}
    torch.cuda.reset_peak_memory_stats()
    h = start_plan(plan_json, broker, device=DEVICE, capacity=JOIN_ROWS, table_store_capacity=JOIN_STORE)
    zero_launches()
    t0 = time.perf_counter()
    produce_users(broker, list(users), list(users.values()), TS0)
    run_until_quiescent(h)
    load_s = time.perf_counter() - t0
    n = n_batches * JOIN_ROWS
    uid = rng.integers(0, 2 * JOIN_USERS, n)
    ts = TS0 + 1 + np.arange(n, dtype=np.int64) * 3
    produce_clicks(broker, uid, ts)
    want = dict_join(users, uid, ts)
    batch_s: list = []
    undo = _timed_batches(torch, batch_s)
    try:
        t0 = time.perf_counter()
        run_until_quiescent(h)
        h.executor.drain()
        torch.cuda.synchronize()
        secs = time.perf_counter() - t0
        # the second part: table changes between stream batches
        next_key, t, changes = JOIN_USERS, int(ts[-1]), 0
        t1 = time.perf_counter()
        for b in range(change_batches):
            if b % JOIN_CHANGE_EVERY == 0:
                ids, regions, next_key = user_changes(rng, users, JOIN_CHANGES, next_key)
                produce_users(broker, ids, regions, t)
                run_until_quiescent(h)
                changes += len(ids)
            uid2 = rng.integers(0, 2 * JOIN_USERS, JOIN_ROWS)
            ts2 = t + 1 + np.arange(JOIN_ROWS, dtype=np.int64) * 3
            t = int(ts2[-1])
            produce_clicks(broker, uid2, ts2)
            want += dict_join(users, uid2, ts2)
            run_until_quiescent(h)
        h.executor.drain()
        torch.cuda.synchronize()
        secs2 = time.perf_counter() - t1
    finally:
        undo()
    PATH_LAUNCHES[path] = read_launches()
    check_path_launches(path, PATH_LAUNCHES[path])
    peak = torch.cuda.max_memory_allocated()
    q = h.executor.query
    require(int(q.state["jtab"]["overflow"]) == 0, f"{path}: table store overflowed")
    require(q.table_store_capacity == JOIN_STORE and q.table_grows == 0,
            f"{path}: table store at {q.table_store_capacity} slots after {q.table_grows} grows")
    got = enriched_sink(broker)
    require(got == want, f"{path}: sink differs from the dict join ({len(got)} vs {len(want)} records, "
            f"first difference at {next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), min(len(got), len(want)))})")
    p50, p99 = np.percentile(np.array(batch_s[:n_batches]) * 1e3, [50, 99])
    print(f"[{path}] BASELINE #3 ENRICHED: {JOIN_USERS} users loaded in {load_s:.3f} s; {n} click events "
          f"in {secs:.3f} s = {n / secs:.1f} events/s, batch p50 {p50:.3f} ms p99 {p99:.3f} ms over "
          f"{n_batches} batches; then {change_batches * JOIN_ROWS} events with {changes} table changes "
          f"between batches in {secs2:.3f} s = {change_batches * JOIN_ROWS / secs2:.1f} events/s; "
          f"{len(got)} sink records equal the dict join; table store {q.table_store_capacity} slots, "
          f"overflow 0; peak device memory {peak} B")
    return dict(events_per_s=n / secs, p50_ms=p50, p99_ms=p99, events_per_s_with_changes=change_batches * JOIN_ROWS / secs2,
                sink_records=len(got), load_s=load_s, peak_bytes=peak)


def phase_join_growth(torch, plan_json, seed):
    """Table growth on the card: the 100,000 users arrive in ticks of
    GROW_TICK records (each tick polled and drained) into a GROW_STORE-slot
    table store, so the load check doubles it to 2^18 while they load;
    then one stream batch must join against every user."""
    from ksql_tpu_torch.runner import run_until_quiescent, start_plan
    from ksql_tpu_torch.runtime.topics import Broker

    rng = np.random.default_rng(seed + 6)
    broker = Broker()
    users = {k: f"r{k % N_REGIONS}" for k in range(JOIN_USERS)}
    h = start_plan(plan_json, broker, device=DEVICE, capacity=JOIN_ROWS, table_store_capacity=GROW_STORE)
    zero_launches()
    t0 = time.perf_counter()
    ids = list(users)
    for start in range(0, JOIN_USERS, GROW_TICK):
        chunk = ids[start:start + GROW_TICK]
        produce_users(broker, chunk, [users[k] for k in chunk], TS0)
        run_until_quiescent(h)
        h.executor.drain()
    load_s = time.perf_counter() - t0
    uid = rng.integers(0, 2 * JOIN_USERS, JOIN_ROWS)
    ts = TS0 + 1 + np.arange(JOIN_ROWS, dtype=np.int64) * 3
    produce_clicks(broker, uid, ts)
    run_until_quiescent(h)
    h.executor.drain()
    torch.cuda.synchronize()
    PATH_LAUNCHES["9g"] = read_launches()
    check_path_launches("9g", PATH_LAUNCHES["9g"])
    q = h.executor.query
    require(q.table_grows >= 3 and q.table_store_capacity == JOIN_STORE,
            f"9g: table store at {q.table_store_capacity} slots after {q.table_grows} grows")
    require(int(q.state["jtab"]["overflow"]) == 0, "9g: table store overflowed")
    got = enriched_sink(broker)
    want = dict_join(users, uid, ts)
    require(got == want, f"9g: sink differs from the dict join ({len(got)} vs {len(want)} records)")
    print(f"[9g] table growth: {JOIN_USERS} users in ticks of {GROW_TICK} in {load_s:.3f} s; "
          f"{q.table_grows} grows {GROW_STORE} -> {q.table_store_capacity} slots (host rebuild s "
          f"{[round(x, 4) for x in q.table_rebuild_seconds]}); {len(got)} enriched rows equal the dict join, "
          "overflow 0")
    return dict(grows=q.table_grows, rebuild_seconds=q.table_rebuild_seconds, load_s=load_s)


# ------------------------------------------------------------- phase 10
SS_BATCHES = 16  # a side (cut from 32 for the script's time); 32 batches wrap each 2^14 ring twice
SS_GROW_BATCHES = 16  # a side
SS_GROW_BUFFER = 512  # ss_buffer_capacity of phase 10g (B starts at SS_ROWS)
SS_GROW_OUT = 64  # ss_out_capacity of phase 10g
SS_FLUSH_MS = 10 * SS_RETENTION_MS  # flush_time this far past the last record


def ss_traffic(seed, n_batches=2 * SS_BATCHES):
    """bench.py:610-665's traffic: batch ``b`` (left when even) of SS_ROWS
    records, ID uniform over SS_KEYS, V = ID, ts = TS0 + (b * SS_ROWS + i)
    * 2 ms.  Returns (ids, ts), both [n_batches, SS_ROWS]."""
    rng = np.random.default_rng(seed + 13)
    ids = rng.integers(0, SS_KEYS, (n_batches, SS_ROWS))
    ts = TS0 + (np.arange(n_batches)[:, None] * SS_ROWS + np.arange(SS_ROWS)[None, :]) * SS_STEP_MS
    return ids, ts


def produce_ss_batch(broker, b, ids, ts):
    from ksql_tpu_torch.runtime.topics import Record

    topic = broker.create_topic("lt" if b % 2 == 0 else "rt")
    for k, t in zip(ids.tolist(), ts.tolist()):
        topic.produce(Record(key=k, value=f'{{"V":{k}}}', timestamp=t))


def start_ss(plan_json, device, buffer=None, out_cap=None):
    """BASELINE #4's query on a fresh broker: bench.py's rings of SS_RING
    entries and 8 x SS_ROWS match lanes unless given."""
    from ksql_tpu_torch.runner import start_plan
    from ksql_tpu_torch.runtime.topics import Broker

    broker = Broker()
    return broker, start_plan(plan_json, broker, device=device, capacity=SS_ROWS,
                              ss_buffer_capacity=buffer or SS_RING,
                              ss_out_capacity=out_cap or 8 * SS_ROWS)


def ss_ticks(torch, broker, h, ids, ts, first=0, device=DEVICE):
    """Batches ``first``.. of the traffic, one a tick: produced, polled and
    drained (the join's expiry runs at the drain), as
    ``tests/test_device_join.py::_run_ss`` drives its feed.  Returns the
    host seconds of each tick, synchronized, production left out."""
    from ksql_tpu_torch.runner import run_until_quiescent

    secs = []
    for b in range(len(ids)):
        produce_ss_batch(broker, first + b, ids[b], ts[b])
        t0 = time.perf_counter()
        run_until_quiescent(h)
        h.executor.drain()
        if device != "cpu":
            torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    return secs


def drive_ss(torch, plan_json, ids, ts, device, buffer=None, out_cap=None, path=None):
    """BASELINE #4 through ``start_plan``: every batch a tick, then
    ``flush_time`` SS_FLUSH_MS past the last record.  With a ``path``, the
    launch counts are set to 0 just before the run and read just after it.
    Returns (broker, handle, per-tick seconds, flush seconds)."""
    broker, h = start_ss(plan_json, device, buffer, out_cap)
    if path is not None:
        zero_launches()
    secs = ss_ticks(torch, broker, h, ids, ts, device=device)
    t0 = time.perf_counter()
    h.executor.flush_time(int(ts[-1, -1]) + SS_FLUSH_MS)
    if device != "cpu":
        torch.cuda.synchronize()
    flush_s = time.perf_counter() - t0
    if path is not None:
        PATH_LAUNCHES[path] = read_launches()
        check_path_launches(path, PATH_LAUNCHES[path])
    return broker, h, secs, flush_s


def ss_pair_counts(ids, ts):
    """(joined rows, padded rows) of BASELINE #4 by numpy: the (L, R) pairs
    with equal ID and |t_l - t_r| <= 10 s, and the lefts with none."""
    lid, lts = ids[0::2].ravel(), ts[0::2].ravel() - TS0
    rid, rts = ids[1::2].ravel(), ts[1::2].ravel() - TS0
    rk = np.sort(rid * (1 << 40) + rts)
    lk = lid * (1 << 40) + lts
    cnt = (np.searchsorted(rk, lk + SS_WITHIN_MS, "right")
           - np.searchsorted(rk, lk - SS_WITHIN_MS, "left"))
    return int(cnt.sum()), int((cnt == 0).sum())


def ss_sink_counts(records):
    joined = sum(1 for _k, v, _t, _w in records if json.loads(v)["RV"] is not None)
    return joined, len(records) - joined


def phase_ss_e2e(torch, plan_json, seed):
    """BASELINE #4 end to end (``ksql_tpu_torch/plans/ss_join_grace.json``,
    LEFTS LEFT JOIN RIGHTS WITHIN 10 SECONDS GRACE PERIOD 1 SECOND) at
    bench.py's sizes: 16 batches a side of 2,048 records, alternating, one
    a tick, into rings of 2^14 entries with 8 x 2,048 match lanes, then a
    flush.  The sink must equal the port's CPU run record for record; the
    joined rows must equal a numpy count of the pairs, the padded rows the
    lefts without a pair; no loss, no match overflow, no grow."""
    ids, ts = ss_traffic(seed)
    n = ids.size
    torch.cuda.reset_peak_memory_stats()
    broker, h, tick_s, flush_s = drive_ss(torch, plan_json, ids, ts, DEVICE, path="10")
    peak = torch.cuda.max_memory_allocated()
    q = h.executor.query
    require(q.ss_grows == 0 and q.ss_out_grows == 0 and q.ss_capacity == SS_RING
            and q.ss_out_cap == 8 * SS_ROWS,
            f"10: rings {q.ss_capacity} after {q.ss_grows} grows, lanes {q.ss_out_cap}")
    got = sink_records(broker, "J")
    joined, pads = ss_sink_counts(got)
    want_joined, want_pads = ss_pair_counts(ids, ts)
    require((joined, pads) == (want_joined, want_pads),
            f"10: {joined} joined / {pads} padded rows, numpy says {want_joined} / {want_pads}")
    t0 = time.perf_counter()
    cpu_broker, _h, _s, _f = drive_ss(torch, plan_json, ids, ts, "cpu")
    cpu_s = time.perf_counter() - t0
    require(sink_records(cpu_broker, "J") == got, "10: card sink differs from the CPU run")
    secs = sum(tick_s) + flush_s
    p50, p99 = np.percentile(np.array(tick_s) * 1e3, [50, 99])
    print(f"[10] BASELINE #4 ss join: {n} events in {len(tick_s)} ticks, {secs:.3f} s = {n / secs:.1f} "
          f"events/s; batch p50 {p50:.3f} ms p99 {p99:.3f} ms (first tick {tick_s[0] * 1e3:.3f} ms, "
          f"slowest {max(tick_s) * 1e3:.3f} ms at tick {int(np.argmax(tick_s))}); flush {flush_s * 1e3:.3f} ms; "
          f"{len(got)} sink records ({joined} joined, {pads} null-padded) equal the numpy counts and the "
          f"CPU run ({cpu_s:.3f} s); rings {q.ss_capacity}, lanes {q.ss_out_cap}, no grow; peak device "
          f"memory {peak} B")
    return dict(events_per_s=n / secs, p50_ms=p50, p99_ms=p99, flush_ms=flush_s * 1e3,
                first_tick_ms=tick_s[0] * 1e3, max_tick_ms=max(tick_s) * 1e3,
                sink_records=len(got), joined=joined, padded=pads, cpu_s=cpu_s, peak_bytes=peak)


def phase_ss_growth(torch, plan_json, seed):
    """Both growths on the card: the first 16 batches a side of phase 10's
    traffic with ``ss_buffer_capacity`` 512 (the rings start at 2,048
    entries and must reach 8,192: a side keeps about 5,250 entries within
    its 21 s retention) and 64 match lanes (about 256 matches a batch: at
    least two doublings).  The sink must equal a run of phase 10's
    settings over the same records."""
    ids, ts = ss_traffic(seed, 2 * SS_GROW_BATCHES)
    broker, h, tick_s, _f = drive_ss(torch, plan_json, ids, ts, DEVICE, buffer=SS_GROW_BUFFER,
                                     out_cap=SS_GROW_OUT, path="10g")
    q = h.executor.query
    require(q.ss_capacity >= 4 * SS_ROWS and q.ss_grows >= 2,
            f"10g: rings at {q.ss_capacity} after {q.ss_grows} grows")
    require(q.ss_out_cap >= 4 * SS_GROW_OUT and q.ss_out_grows >= 2,
            f"10g: match lanes at {q.ss_out_cap} after {q.ss_out_grows} doublings")
    ref_broker, _h, _s, _f = drive_ss(torch, plan_json, ids, ts, DEVICE)
    got = sink_records(broker, "J")
    require(got == sink_records(ref_broker, "J"), "10g: sink differs from the run at phase 10's sizes")
    print(f"[10g] growth: {ids.size} events; rings {SS_ROWS} -> {q.ss_capacity} in {q.ss_grows} grows "
          f"(host rebuild s {[round(x, 4) for x in q.ss_rebuild_seconds]}), match lanes {SS_GROW_OUT} -> "
          f"{q.ss_out_cap} in {q.ss_out_grows} doublings; {len(got)} sink records equal the run at "
          "phase 10's sizes")
    return dict(ring=q.ss_capacity, grows=q.ss_grows, rebuild_seconds=q.ss_rebuild_seconds,
                out_cap=q.ss_out_cap, out_grows=q.ss_out_grows)


def _ss_head(torch, plan_json, seed, warm=8, n_batches=4):
    """Phase 10's query after its first ``warm`` batches; returns the drive
    of the breakdown's window: the next ``n_batches`` ticks, in wall
    seconds (production left out)."""
    ids, ts = ss_traffic(seed, warm + n_batches)
    broker, h = start_ss(plan_json, DEVICE)
    ss_ticks(torch, broker, h, ids[:warm], ts[:warm])
    return lambda: sum(ss_ticks(torch, broker, h, ids[warm:], ts[warm:], first=warm))


# ------------------------------------------------------------- phase 11
SESS_ROWS = 8192  # BASELINE #5's batch: min(8192, CAPACITY) (bench.py:677)
SESS_STORE = 1 << 20  # bench.py:678 (STORE)
SESS_SLOTS = 16  # bench.py:679: session_slots presized for the zipf tail
SESS_BATCHES = 8  # phase 11's depth, cut from 16 for the script's time
SESS_GAP_MS = 30_000
SESS_STEP_MS = 17  # bench.py:139, a record every 17 ms
#: phase 11's batches replayed through the CPU twins for the sink check
SESS_CPU_BATCHES = 8
SESS_GROW_BATCHES = 8
#: phase 11g's store: grows at least once, clear of the overflow defect of
#: ROADMAP C (scripts/torch_store_overflow.py --session counts it)
SESS_GROW_STORE = 1 << 14
SESS_GROW_SLOTS = 4  # the reference's default session_slots
SESS_2W_WARM = 8
SESS_2W_SLOTS = 32
#: phase 2w's grace: with the 30 s gap, rows 9-11 min late straddle it
SESS_2W_GRACE_MS = 9 * 60_000 + 30_000


def session_traffic(n_batches=SESS_BATCHES, n=None):
    """bench.py:119-146 (``_pv_batches``) at BASELINE #5's batch: seed 7,
    per batch SESS_ROWS URLs drawn zipf(1.3) over 50,000 and as many
    USER_IDs uniform over 1..999, records 17 ms apart in increasing time.  Returns
    (url_idx, user_ids, ts)."""
    n = n or SESS_ROWS
    rng = np.random.default_rng(7)
    url_idx, uid = [], []
    for _ in range(n_batches):
        url_idx.append(rng.zipf(1.3, size=n).astype(np.int64) % N_URLS)
        uid.append(rng.integers(1, 1000, n))
    ts = TS0 + np.arange(n_batches * n, dtype=np.int64) * SESS_STEP_MS
    return np.concatenate(url_idx), np.concatenate(uid), ts


def session_reference(url_idx, ts, gap=SESS_GAP_MS):
    """The live sessions by numpy: per URL its timestamps sorted and split
    where two lie more than ``gap`` apart: {(URL, start, end): count}."""
    order = np.lexsort((ts, url_idx))
    u, t = url_idx[order], ts[order]
    new = np.ones(len(u), bool)
    new[1:] = (u[1:] != u[:-1]) | (t[1:] - t[:-1] > gap)
    starts = np.nonzero(new)[0]
    ends = np.append(starts[1:], len(u)) - 1
    return {(f"/page/{u[s]}", int(t[s]), int(t[e])): int(e - s + 1) for s, e in zip(starts, ends)}


def live_sessions(records):
    """The sink's live sessions: the last record per (URL, window) that no
    later tombstone removed; with the tombstone and merged-row counts."""
    live, tombs = {}, 0
    for key, value, _ts, window in records:
        k = (key, window[0], window[1])
        if value is None:
            live.pop(k, None)
            tombs += 1
        else:
            live[k] = json.loads(value)["CNT"]
    return live, tombs, len(records) - tombs


def run_session(torch, plan_json, url_idx, uid, ts, device, store, slots, log=None, path=None):
    """BASELINE #5's plan through ``run_main_path`` at its batch; with a
    ``log`` list, each micro-batch's synchronized wall seconds and emitted
    records are appended to it."""
    from ksql_tpu_torch.runtime.device_executor import TorchDeviceExecutor

    run_batch = TorchDeviceExecutor._run_batch

    def logged(self):
        t0 = time.perf_counter()
        out = run_batch(self)
        if device != "cpu":
            torch.cuda.synchronize()
        log.append((time.perf_counter() - t0, len(out)))
        return out

    if log is not None:
        TorchDeviceExecutor._run_batch = logged
    try:
        return run_main_path(torch, plan_json, url_idx, ts, device, store, rows=SESS_ROWS,
                             user_ids=uid, path=path, session_slots=slots)
    finally:
        TorchDeviceExecutor._run_batch = run_batch


def phase_session_e2e(torch, plan_json, seed):
    """BASELINE #5 end to end (``ksql_tpu_torch/plans/pv_sessions.json``,
    COUNT(*) per URL over SESSION (30 SECONDS)) through ``run_plan`` at
    bench.py's sizes (SESS_BATCHES, 8 of its 16): 8 x 8,192 records, a 2^20-slot store, 16 session
    slots.  The sink must equal the port's CPU run record for record (over
    the first SESS_CPU_BATCHES batches); the live sessions at the end must
    equal the numpy sessions; no overflow; the session slots must grow.
    Returns the summary and the sink's records of the first
    SESS_GROW_BATCHES batches (phase 11g's reference)."""
    url_idx, uid, ts = session_traffic()
    n = len(ts)
    torch.cuda.reset_peak_memory_stats()
    log: list = []
    broker, ex, secs = run_session(torch, plan_json, url_idx, uid, ts, DEVICE, SESS_STORE,
                                   SESS_SLOTS, log, path="11")
    peak = torch.cuda.max_memory_allocated()
    q = ex.query
    got = sink_records(broker, "SESSIONS")
    require(int(q.state["overflow"]) == 0, "11: store overflowed")
    require(len(log) == SESS_BATCHES and sum(c for _s, c in log) == len(got),
            f"11: {len(log)} batches emitted {sum(c for _s, c in log)} of {len(got)} sink records")
    require(q.session_grows >= 1 and q.session_slots > SESS_SLOTS,
            f"11: session slots {q.session_slots} after {q.session_grows} doublings")
    live, tombs, merged = live_sessions(got)
    want = session_reference(url_idx, ts)
    require(live == want, f"11: {len(live)} live sessions in the sink, numpy says {len(want)} "
            f"({len(set(live.items()) ^ set(want.items()))} differ)")
    k = SESS_CPU_BATCHES * SESS_ROWS
    t0 = time.perf_counter()
    cpu_broker, _ex, _s = run_session(torch, plan_json, url_idx[:k], uid[:k], ts[:k], "cpu",
                                      SESS_STORE, SESS_SLOTS)
    cpu_s = time.perf_counter() - t0
    prefix = sum(c for _s, c in log[:SESS_CPU_BATCHES])
    require(sink_records(cpu_broker, "SESSIONS") == got[:prefix],
            f"11: card sink differs from the CPU run over {SESS_CPU_BATCHES} batches")
    batch_s = np.array([s for s, _c in log]) * 1e3
    p50, p99 = np.percentile(batch_s, [50, 99])
    urls = len(np.unique(url_idx))
    print(f"[11] BASELINE #5 sessions: {n} events in {secs:.3f} s = {n / secs:.1f} events/s; batch p50 "
          f"{p50:.3f} ms p99 {p99:.3f} ms (first {batch_s[0]:.3f} ms, slowest {batch_s.max():.3f} ms); "
          f"session slots {SESS_SLOTS} -> {q.session_slots} in {q.session_grows} restarts; store "
          f"{q.store_capacity} slots, {q.grows} grows, overflow 0; {urls} URLs, {len(want)} live sessions "
          f"equal the numpy sessions; {len(got)} sink records ({tombs} tombstones, {merged} merged "
          f"sessions) equal the CPU run over {SESS_CPU_BATCHES} batches ({cpu_s:.3f} s); peak device "
          f"memory {peak} B")
    out = dict(events_per_s=n / secs, p50_ms=p50, p99_ms=p99, first_batch_ms=batch_s[0],
               max_batch_ms=batch_s.max(), session_slots=q.session_slots, restarts=q.session_grows,
               sink_records=len(got), tombstones=tombs, merged=merged, live_sessions=len(want),
               cpu_s=cpu_s, peak_bytes=peak)
    return out, got[:sum(c for _s, c in log[:SESS_GROW_BATCHES])]


def phase_session_growth(torch, plan_json, seed, want):
    """Both growths on the card: phase 11's first 8 batches with the
    reference's 4 session slots and a SESS_GROW_STORE-slot store.  The
    slots must reach 32, the store must grow, nothing may overflow, and the
    sink must equal phase 11's over the same records."""
    url_idx, uid, ts = session_traffic(SESS_GROW_BATCHES)
    broker, ex, secs = run_session(torch, plan_json, url_idx, uid, ts, DEVICE, SESS_GROW_STORE,
                                   SESS_GROW_SLOTS, path="11g")
    q = ex.query
    require(q.session_slots >= 32 and q.session_grows >= 3,
            f"11g: session slots {q.session_slots} after {q.session_grows} doublings")
    require(q.grows >= 1 and q.store_capacity > SESS_GROW_STORE,
            f"11g: store at {q.store_capacity} slots after {q.grows} grows")
    require(int(q.state["overflow"]) == 0, "11g: store overflowed")
    got = sink_records(broker, "SESSIONS")
    require(got == want, f"11g: sink differs from phase 11's ({len(got)} vs {len(want)} records)")
    print(f"[11g] growth: {len(ts)} events in {secs:.3f} s; session slots {SESS_GROW_SLOTS} -> "
          f"{q.session_slots} in {q.session_grows} restarts; store {SESS_GROW_STORE} -> {q.store_capacity} "
          f"slots in {q.grows} grows (host rebuild s {[round(x, 4) for x in q.rebuild_seconds]}); "
          f"{len(got)} sink records equal phase 11's, overflow 0")
    return dict(session_slots=q.session_slots, restarts=q.session_grows, grows=q.grows,
                rebuild_seconds=q.rebuild_seconds, seconds=secs)


def _session_head(torch, plan_json, warm=8, n_batches=4):
    """Phase 11's query after its first ``warm`` batches; returns the drive
    of the breakdown's window: the next ``n_batches`` batches, in wall
    seconds (production left out)."""
    from ksql_tpu_torch.runner import run_until_quiescent, start_plan
    from ksql_tpu_torch.runtime.topics import Broker

    url_idx, uid, ts = session_traffic(warm + n_batches)
    broker = Broker()
    h = start_plan(plan_json, broker, device=DEVICE, capacity=SESS_ROWS, store_capacity=SESS_STORE,
                   session_slots=SESS_SLOTS)
    cut = warm * SESS_ROWS
    produce_pageviews(broker, url_idx[:cut], ts[:cut], uid[:cut])
    run_until_quiescent(h)
    produce_pageviews(broker, url_idx[cut:], ts[cut:], uid[cut:])

    def drive():
        t0 = time.perf_counter()
        run_until_quiescent(h)
        h.executor.drain()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    return drive


def make_session_case(torch, plan_json, seed, dev, n=None, store=SESS_STORE, slots=SESS_2W_SLOTS,
                      warm=SESS_2W_WARM):
    """Phase 2w's case: BASELINE #5's query on ``dev`` after phase 11's
    first ``warm`` batches (of ``n`` rows, SESS_ROWS unless given, into a
    ``store``-slot store with ``slots`` session slots), and the next batch
    with 5% null keys, 2% rows 9-11 minutes late and 1% repeated
    timestamps.  Returns the query, the batch's arrays and its tensors
    after its pre-ops: reprs, valid, active, row_valid, ts."""
    from ksql_tpu_torch.common.batch import HostBatch
    from ksql_tpu_torch.compiler.torch_expr import _repr64
    from ksql_tpu_torch.execution.steps import plan_from_json
    from ksql_tpu_torch.runtime.lowering import TorchCompiledQuery

    n = n or SESS_ROWS
    url_idx, uid, ts = session_traffic(warm + 1, n)
    q = TorchCompiledQuery(plan_from_json(plan_json), capacity=n, store_capacity=store,
                           device=dev, session_slots=slots)
    schema = q.source.schema

    def rows(lo, urls):
        return [{"URL": u, "USER_ID": int(i), "VIEWTIME": int(t)}
                for u, i, t in zip(urls, uid[lo:lo + n].tolist(), ts[lo:lo + n].tolist())]

    for b in range(warm):
        lo = b * n
        q.process(HostBatch.from_rows(schema, rows(lo, [f"/page/{u}" for u in url_idx[lo:lo + n]]),
                                      timestamps=ts[lo:lo + n].tolist()))
    rng = np.random.default_rng(seed + 40)
    lo = warm * n
    t9 = ts[lo:].copy()
    late = rng.random(n) < 0.02
    t9[late] -= rng.integers(9 * 60_000, 11 * 60_000, int(late.sum()))
    dup = np.nonzero(rng.random(n) < 0.01)[0]
    dup = dup[dup > 0]
    t9[dup] = t9[dup - 1]
    ts[lo:] = t9
    null = rng.random(n) < 0.05
    urls = [None if z else f"/page/{u}" for z, u in zip(null.tolist(), url_idx[lo:].tolist())]
    arrays = q.upload(q.layout.encode(HostBatch.from_rows(schema, rows(lo, urls), timestamps=t9.tolist())))
    env = q._source_env(arrays)
    env, active = q._apply_ops(q.pre_ops, env, arrays["row_valid"], n)
    keys = q._key_cols(env, n, dev)
    return q, arrays, {
        "reprs": torch.stack([_repr64(kc) for kc in keys]).contiguous(),
        "valid": torch.stack([kc.valid for kc in keys]).contiguous(),
        "active": active.contiguous(), "row_valid": arrays["row_valid"], "ts": arrays["ts"],
        "late": int(late.sum()), "dups": int(dup.size), "nulls": int(null.sum()),
    }


def _argsort_lsd(torch, k1, k2):
    """K13's yardstick: two stable torch.argsort calls, least significant
    key first."""
    o = torch.argsort(k2, stable=True)
    return o[torch.argsort(k1[o], stable=True)]


def phase_session_kernels(torch, plan_json, seed, case=None, timed=True):
    """BASELINE #5's kernels against their twins at its shapes, on phase
    2w's case (``make_session_case``, or ``case``): K1's session mode,
    K14's prologue (under a 9.5 min grace), K13 on the rows, K14 first and
    items, K13 on the items, K15, K16 delete, K2 and K16 write; everything
    exact, masked lanes and the dump slot included.  Returns ``{kernel:
    {mode: record}}`` and K2's and K13-on-rows' records at these shapes
    (with ``timed`` False it compares only, and returns nothing)."""
    from ksql_tpu_torch.ops import hash_store as hs
    from ksql_tpu_torch.ops import session as sess

    dev = torch.device(DEVICE)
    q, arrays, c = case or make_session_case(torch, plan_json, seed, dev)
    meas = measure if timed else (lambda *_a, **_k: {})
    n, cap, S = q.capacity, q.store_capacity, q.session_slots
    m = n * (S + 1)
    store = q.state
    k = c["reprs"].shape[0]
    comps = q.store_layout.components
    cb = sum(np.dtype(x.dtype).itemsize for x in comps)  # component bytes an item
    recs: dict = {}
    extra: dict = {}

    def done(kernel, mode, rec, what):
        if timed:
            recs.setdefault(kernel, {})[mode] = dict(rec, max_abs_err=0.0)
            _report("2w", f"{kernel}[{mode}] ({what})", recs[kernel][mode])

    # ---- K1, session mode
    args = (c["reprs"], c["valid"], c["active"])
    got, want = hs.session_prologue(*args), hs.session_prologue_plain(*args)
    _assert_tree(torch, "row_prologue[session]", got, want)
    done("row_prologue", "session", meas(
        torch, "row_prologue", lambda: hs.session_prologue(*args),
        lambda: hs.session_prologue_plain(*args), n * (9 * k + 1) + n * 9, n * 30 * (k + 1)),
        f"{n} rows, {c['nulls']} null keys; no single PyTorch call")
    act1, khash = got
    # ---- K14 prologue
    pro = (c["row_valid"], c["ts"], act1, store["max_ts"], SESS_2W_GRACE_MS, SESS_GAP_MS)
    got, want = sess.session_prologue(*pro), sess.session_prologue_plain(*pro)
    _assert_tree(torch, "session_items[prologue]", got, want)
    active, scal = got
    dropped = int((act1 & ~active).sum())
    require(not timed or 0 < dropped < c["late"], f"2w: {dropped} of {c['late']} late rows dropped")
    done("session_items", "prologue", meas(
        torch, "session_items", lambda: sess.session_prologue(*pro),
        lambda: sess.session_prologue_plain(*pro), n * 11 + 8 + 16, n * 8),
        f"{dropped} of {c['late']} late rows dropped; one block; no single PyTorch call")
    ts = c["ts"]
    contribs = [torch.where(active, ts, torch.full_like(ts, np.iinfo(np.int64).min)), active.long()]
    # ---- K13 on the rows
    khs = torch.where(active, khash, torch.zeros_like(khash))
    zeros = torch.zeros_like(khs)
    order0 = sess.seg_sort(khs, zeros)
    _assert_equal(torch, "seg_sort[rows]", order0, sess.seg_sort_plain(khs, zeros))
    extra["seg_sort_rows"] = meas(
        torch, "seg_sort", lambda: sess.seg_sort(khs, zeros), lambda: sess.seg_sort_plain(khs, zeros),
        n * 20, n * 14 * 5, library=lambda: _argsort_lsd(torch, khs, zeros))
    if timed:
        _report("2w", f"seg_sort[rows] ({n} rows; yardstick two stable torch.argsort)",
                dict(extra["seg_sort_rows"], max_abs_err=0.0))
    # ---- K14 first, items
    first = sess.session_first(order0, khash, active)
    _assert_equal(torch, "session_items[first]", first, sess.session_first_plain(order0, khash, active))
    n_first = int(first.sum())
    done("session_items", "first", meas(
        torch, "session_items", lambda: sess.session_first(order0, khash, active),
        lambda: sess.session_first_plain(order0, khash, active), n * 13 + n, n * 6),
        f"{n_first} first rows; no single PyTorch call")
    it_args = (store, cap, S, khash, active, first, ts, c["reprs"], contribs, SESS_GAP_MS,
               SESS_2W_GRACE_MS, scal)
    items = sess.session_items(*it_args)
    _assert_tree(torch, "session_items[items]", items, sess.session_items_plain(*it_args))
    found = int((items["slot"][n:] != cap).sum())
    alive = int(items["alive"].sum())
    done("session_items", "items", meas(
        torch, "session_items", lambda: sess.session_items(*it_args),
        lambda: sess.session_items_plain(*it_args),
        n * (19 + 8 * k + cb) + n_first * S * 17 + found * (16 + 8 * k + cb) + m * (29 + 8 * k + cb),
        m * 40, plain_reps=5),
        f"{m} items, S = {S}: {found} stored sessions found, {alive} alive; no single PyTorch call")
    # ---- K13 on the items
    perm = sess.seg_sort(items["kh"], items["start"])
    _assert_equal(torch, "seg_sort[items]", perm, sess.seg_sort_plain(items["kh"], items["start"]))
    done("seg_sort", "items", meas(
        torch, "seg_sort", lambda: sess.seg_sort(items["kh"], items["start"]),
        lambda: sess.seg_sort_plain(items["kh"], items["start"]), m * 20,
        m * int(np.ceil(np.log2(m))) * 5, library=lambda: _argsort_lsd(torch, items["kh"], items["start"])),
        f"{m} items; yardstick two stable torch.argsort")
    # ---- K15
    mg_args = (items, perm, n, S, SESS_GAP_MS, comps, cap)
    merged = sess.session_merge(*mg_args)
    want = sess.session_merge_plain(*mg_args)
    sf = want["segfirst"].long()
    for key in sess.MERGE_ITEM_KEYS + ("sess_ovf",):
        _assert_tree(torch, f"session_merge.{key}", merged[key], want[key])
    for key in sess.MERGE_SEG_KEYS:
        g, w = merged[key], want[key]
        pick = (lambda x: x[..., sf]) if key != "seg_comps" else (lambda xs: [x[sf] for x in xs])
        _assert_tree(torch, f"session_merge.{key}[segfirst]", pick(g), pick(w))
    require(not timed or int(want["sess_ovf"]) == 0,
            f"2w: {int(want['sess_ovf'])} sessions over {S} slots")
    nseg = int((want["segfirst"] == torch.arange(m, device=dev, dtype=torch.int32)).sum())
    n_ins = int(want["ins_act"].sum())
    run, tiles = longest_run(torch, sess, want["kh"])
    rec = meas(torch, "session_merge", lambda: sess.session_merge(*mg_args),
               lambda: sess.session_merge_plain(*mg_args), merge_bytes(m, nseg, k, cb), m * 30,
               plain_reps=5)
    done("session_merge", "merge", dict(rec, longest_run=run, longest_run_tiles=tiles),
         f"{m} items, {nseg} segments, {n_ins} inserts, longest key run {run} items over {tiles} "
         f"tiles of {sess.MERGE_TILE}; no single PyTorch call")
    # ---- K16 delete, K2, K16 write on two copies of the store
    sk, sp = _clone(store), _clone(store)
    snap = _clone(store)
    sess.session_delete(sk, cap, merged)
    sess.session_delete_plain(sp, cap, want)
    _assert_tree(torch, "session_write[delete]", sk, sp)
    n_del = int((~want["isrow"] & want["alive"]).sum())

    def reset_delete():
        for s in (sk, sp):
            s["occ"].copy_(snap["occ"])
            s["grave"].copy_(snap["grave"])

    done("session_write", "delete", meas(
        torch, "session_write", lambda: sess.session_delete(sk, cap, merged),
        lambda: sess.session_delete_plain(sp, cap, want), m * 2 + n_del * 6 + 2, m * 3,
        reset=reset_delete), f"{n_del} stored sessions merged away; no single PyTorch call")
    reset_delete()
    sess.session_delete(sk, cap, merged)
    sess.session_delete_plain(sp, cap, want)
    snap_del = _clone(sk)
    z32 = torch.zeros(m, dtype=torch.int32, device=dev)
    scratch = hs.init_scratch(cap, dev)
    ins_args = (cap, merged["base"], merged["kh"], merged["rank"], merged["ins_reprs"], z32, merged["ins_act"])
    ins_k = hs.probe_insert(sk, scratch, *ins_args)
    ins_p = hs.probe_insert_plain(sp, *ins_args)
    _assert_equal(torch, "probe_insert[session] slots", ins_k, ins_p)
    _assert_tree(torch, "probe_insert[session] store", sk, sp)
    # inserts that claim an empty slot (the others resolve on a slot, live or
    # a grave, that holds their (khash, rank))
    ins_slots = ins_p[want["ins_act"] & (ins_p != cap)].long()
    n_new = int((~(snap_del["occ"][ins_slots] | snap_del["grave"][ins_slots])).sum())

    def reset_insert():
        for s in (sk, sp):
            _restore(s, snap_del)

    extra["probe_insert_session"] = meas(
        torch, "probe_insert", lambda: hs.probe_insert(sk, scratch, *ins_args),
        lambda: hs.probe_insert_plain(sp, *ins_args),
        # every item's active flag and slot; an insert's base, kh, rank,
        # key reprs and knull, its probe (occ, grave, khash, wstart) and its
        # occ, grave, key and knull writes; a claim's khash and wstart
        m * (1 + 4) + n_ins * ((24 + 8 * k) + 18 + (6 + 8 * k)) + n_new * 16, m * 20,
        reset=reset_insert, plain_reps=5)
    if timed:
        _report("2w", f"probe_insert at the session shapes ({n_ins} inserts of {m} items, "
                f"{n_new} claim a slot)",
                dict(extra["probe_insert_session"], max_abs_err=0.0))
    reset_insert()
    hs.probe_insert(sk, scratch, *ins_args)
    hs.probe_insert_plain(sp, *ins_args)
    snap_ins = _clone(sk)
    lanes_k = sess.session_write(sk, cap, merged, ins_k, scal)
    lanes_p = sess.session_write_plain(sp, cap, want, ins_p, scal)
    _assert_tree(torch, "session_write[write] lanes", lanes_k, lanes_p)
    _assert_tree(torch, "session_write[write] store", sk, sp)
    n_emit = int(lanes_p["mask"].sum())
    n_tomb = int((lanes_p["mask"] & lanes_p["tombstone"]).sum())

    def reset_write():
        for s in (sk, sp):
            _restore(s, snap_ins)

    done("session_write", "write", meas(
        torch, "session_write", lambda: sess.session_write(sk, cap, merged, ins_k, scal),
        lambda: sess.session_write_plain(sp, cap, want, ins_p, scal),
        write_bytes(m, nseg, k, cb, n_ins), m * 20, reset=reset_write, plain_reps=5),
        f"{2 * m} lanes, {n_emit} emitted ({n_tomb} tombstones), {n_ins} sessions written; "
        "no single PyTorch call")
    return (recs, extra) if timed else None


def write_bytes(m, nseg, k, cb, n_ins):
    """The bytes K16's write mode must move over ``m`` items (``nseg``
    segments, ``k`` keys, ``cb`` component bytes an item, ``n_ins``
    inserts): each item's flags, slot, times, reprs and components; each
    segment's values once; the 2m lanes written; an insert's store
    writes; max_ts."""
    return (m * (4 + 24 + 8 * k + cb) + nseg * (26 + 8 * k + cb) + 2 * m * (34 + 8 * k + cb)
            + n_ins * (17 + cb) + 16)


def session_write_case(torch, plan_json, seed, dev):
    """K16 write mode's inputs at phase 2w's shapes, made by the twins
    (so that any checkout's kernels meet the same inputs): phase 2w's
    case run through K1's session mode, K14, K13, K15, K16's deletes and
    K2.  Returns ``store`` (after the deletes and K2's inserts), ``cap``,
    ``merged``, ``ins`` (K2's slots), ``scal`` and the counts ``m``,
    ``nseg``, ``n_ins``, ``k``, ``cb``."""
    from ksql_tpu_torch.ops import hash_store as hs
    from ksql_tpu_torch.ops import session as sess

    q, _arrays, c = make_session_case(torch, plan_json, seed, dev)
    n, cap, S = q.capacity, q.store_capacity, q.session_slots
    store = _clone(q.state)
    act1, khash = hs.session_prologue_plain(c["reprs"], c["valid"], c["active"])
    active, scal = sess.session_prologue_plain(c["row_valid"], c["ts"], act1, store["max_ts"],
                                               SESS_2W_GRACE_MS, SESS_GAP_MS)
    ts = c["ts"]
    contribs = [torch.where(active, ts, torch.full_like(ts, np.iinfo(np.int64).min)), active.long()]
    khs = torch.where(active, khash, torch.zeros_like(khash))
    order0 = sess.seg_sort_plain(khs, torch.zeros_like(khs))
    first = sess.session_first_plain(order0, khash, active)
    items = sess.session_items_plain(store, cap, S, khash, active, first, ts, c["reprs"], contribs,
                                     SESS_GAP_MS, SESS_2W_GRACE_MS, scal)
    perm = sess.seg_sort_plain(items["kh"], items["start"])
    comps = q.store_layout.components
    merged = sess.session_merge_plain(items, perm, n, S, SESS_GAP_MS, comps, cap)
    sess.session_delete_plain(store, cap, merged)
    m = n * (S + 1)
    ins = hs.probe_insert_plain(store, cap, merged["base"], merged["kh"], merged["rank"],
                                merged["ins_reprs"], torch.zeros(m, dtype=torch.int32, device=dev),
                                merged["ins_act"])
    nseg = int((merged["segfirst"] == torch.arange(m, device=dev, dtype=torch.int32)).sum())
    return dict(store=store, cap=cap, merged=merged, ins=ins, scal=scal, m=m, nseg=nseg,
                n_ins=int(merged["ins_act"].sum()), k=c["reprs"].shape[0],
                cb=sum(np.dtype(x.dtype).itemsize for x in comps))


# ------------------------------------------------------------------ main
# ------------------------------------------------------ phase 2f, 12-13r
FINAL_GRACE_MS = 10 * 60_000  # phase 2f's grace: windows close 10 min after their end
FINAL_RETENTION_MS = 3 * HOUR_MS  # phase 2f's horizon: 3 h past the window start
FINAL_ADVANCE_MS = 20 * 60_000  # phase 2f's expansion lanes: 1 h windows, k = 3
HOP_ADVANCE_MS = 15 * 60_000  # BASELINE #2's advance (pv_stats_hopping_final.json): k = 4
FINAL_GROW_ROWS = 1 << 20  # phase 12g's batch (see phase_final_growth)
FINAL_GROW_RECORDS = (1 << 20) + (1 << 18)  # a full batch, then a quarter batch
FINAL_GROW_REPEATS = 8  # phase 12g: each URL of an hour's pool seen 8 times
HAVING_MIN_MS = 60_000  # possible_fraud's window
HAVING_RETRACT_BATCHES = 4  # phase 13r's depth, on the card and in the CPU run
HAVING_BATCHES = 4  # phase 13's depth, cut from 16 and 8 for the script's time (PERF.md §4)
PV_STEP_MS = 17  # bench.py:139: phases 12 and 13 space their records as phase 3 does


def make_suppress_case(torch, rng, dev, n=N_ROWS, capacity=STORE, advance=FINAL_ADVANCE_MS):
    """Phase 2f's inputs: a batch of ``n`` rows 17 ms apart with 2% of them
    up to 90 min late and 1% padding, its tumbling lanes and its k = 1 h /
    ``advance`` hopping lanes (with 10% inactive); a ``capacity``-slot EMIT
    FINAL store 70% full, 20% of the occupied slots dirty and 5% emitted,
    whose window starts put their close (end + 10 min) and horizon (start +
    3 h) before, inside and after the batch's stream times; the rows' slots
    and the hopping lanes' slots (10% of each overflowed into the dump
    slot); and, when the store holds ``n`` live slots, HAVING verdicts and
    a HAVING lane set (one masked lane per slot, 60% masked)."""
    from ksql_tpu_torch.ops import hash_store as hs
    from ksql_tpu_torch.ops import window as W

    t0 = TS0 + 5 * HOUR_MS
    ts_np = t0 + np.arange(n, dtype=np.int64) * 17
    late = rng.random(n) < 0.02
    ts_np[late] -= rng.integers(0, 90 * 60_000, int(late.sum()))
    row_valid_np = rng.random(n) > 0.01
    ts = torch.from_numpy(ts_np).to(dev)
    row_valid = torch.from_numpy(row_valid_np).to(dev)
    act_rows = row_valid & torch.from_numpy(rng.random(n) > 0.1).to(dev)
    tws = ts - torch.remainder(ts, HOUR_MS)
    hws, in_win = W.hopping_starts(ts, HOUR_MS, advance)
    hact = W.expand(act_rows, HOUR_MS // advance) & in_win
    c1 = capacity + 1
    occ = rng.random(c1) < 0.7
    occ[-1] = False
    dirty = occ & (rng.random(c1) < 0.2)
    emitted = occ & (rng.random(c1) < 0.05)
    wst = (t0 - t0 % HOUR_MS) + rng.integers(-5, 3, c1) * HOUR_MS
    born = np.where(occ, rng.integers(0, 1 << 40, c1), np.iinfo(np.int64).max)
    layout = hs.StoreLayout(capacity, 1, (
        hs.AggComponent("max", "int64", np.iinfo(np.int64).min),
        hs.AggComponent("add", "int64", 0),
    ), windowed=True)
    store = {k: v.to(dev) for k, v in hs.init_store(layout, "cpu").items()}
    for name, arr in (("occ", occ), ("dirty", dirty), ("emitted", emitted), ("wstart", wst),
                      ("born", born)):
        store[name] = torch.from_numpy(arr).to(dev)
    store["grave"] = torch.from_numpy(~occ & (rng.random(c1) < 0.05)).to(dev)
    store["a0"] = torch.from_numpy(np.where(occ, wst + rng.integers(0, HOUR_MS, c1),
                                            np.iinfo(np.int64).min)).to(dev)
    store["a1"] = torch.from_numpy(np.where(occ, rng.integers(1, 1000, c1), 0)).to(dev)
    store["max_ts"].fill_(t0 - 30 * 60_000)
    store["emit_clock"] = torch.tensor(t0 - 60_000, dtype=torch.int64, device=dev)
    store["row_clock"] = torch.tensor(1 << 30, dtype=torch.int64, device=dev)
    live = np.nonzero(occ)[0]
    slots_np = rng.choice(live, n).astype(np.int32)
    slots_np[rng.random(n) < 0.1] = capacity
    case = dict(ts=ts, row_valid=row_valid, act_rows=act_rows, tws=tws, hws=hws.contiguous(),
                hact=hact.contiguous(), layout=layout, store=store,
                slots=torch.from_numpy(slots_np).to(dev))
    if n <= live.size:
        winners = rng.choice(live, n, replace=False).astype(np.int32)
        mask_np = rng.random(n) < 0.6
        hslots = np.where(mask_np, winners, rng.choice(live, n).astype(np.int32))
        hslots[~mask_np & (rng.random(n) < 0.3)] = capacity
        case.update(
            hpass=torch.from_numpy(rng.random(c1) < 0.5).to(dev),
            hslots=torch.from_numpy(hslots).to(dev), hmask=torch.from_numpy(mask_np).to(dev),
            hdata=torch.from_numpy(rng.random(n) < 0.5).to(dev),
            hvalid=torch.from_numpy(rng.random(n) > 0.05).to(dev))
    lane_slots = rng.choice(live, hact.shape[0]).astype(np.int32)
    lane_slots[rng.random(hact.shape[0]) < 0.1] = capacity
    case["hop_slots"] = torch.from_numpy(lane_slots).to(dev)
    return case


def _check_suppress_clock(torch, c, mode, grace):
    """K17 on ``c``'s tumbling (``mode`` "tumbling") or hopping lanes
    against its twin, exact; returns its outputs, its measure record and
    what it saw."""
    from ksql_tpu_torch.ops import suppress as sup

    ws, act = (c["tws"], c["act_rows"]) if mode == "tumbling" else (c["hws"], c["hact"])
    store = c["store"]
    args = (c["ts"], ws, act, c["row_valid"], store["max_ts"], store["emit_clock"], HOUR_MS, grace)
    got, want = sup.suppress_clock(*args), sup.suppress_clock_plain(*args)
    _assert_tree(torch, f"suppress_clock[{mode}]", list(got), list(want))
    require(bool((torch.sort(got[2]).values == got[2]).all()),
            "suppress_clock: the emission clock is not non-decreasing")
    n, lanes = c["ts"].shape[0], act.shape[0]
    cut = int(act.sum() - got[0].sum())
    require(cut > 0, f"suppress_clock[{mode}]: the late rows should be cut")
    # the yardstick: the two running maxima alone, as two torch.cummax
    # calls over the lanes and the rows masked beforehand
    neg = torch.full((lanes,), np.iinfo(np.int64).min, dtype=torch.int64, device=act.device)
    lane_vals = torch.where(act, c["ts"].repeat(lanes // n), neg)
    row_vals = torch.where(c["row_valid"], c["ts"], neg[:n])
    rec = measure(torch, "suppress_clock", lambda: sup.suppress_clock(*args),
                  lambda: sup.suppress_clock_plain(*args),
                  lanes * (8 + 1 + 1 + 8) + n * (8 + 1 + 8), lanes * 6 + n * 3,
                  library=lambda: (torch.cummax(lane_vals, 0), torch.cummax(row_vals, 0)))
    return got, rec, f"{n} rows, {lanes} lanes, {cut} late lanes cut"


def _check_suppress_close(torch, c, slots, active, cm_emit, grace, per_call=1):
    """K18 on ``c``'s store for the lanes ``slots``/``active`` and K17's
    ``cm_emit`` against its twin, exact; returns the store after it, its
    measure record (whose trace must hold ``per_call`` kernel records a
    call; None: counted from a fenced call), what it saw and how many
    candidates keep waiting."""
    from ksql_tpu_torch.ops import suppress as sup

    s0, layout = _clone(c["store"]), c["layout"]
    capacity = layout.capacity
    sk, sp = _clone(s0), _clone(s0)
    args = (layout, slots, active, cm_emit, HOUR_MS, grace, FINAL_RETENTION_MS)
    got = sup.suppress_close(sk, *args)
    want = sup.suppress_close_plain(sp, *args)
    _assert_equal(torch, "suppress_close.suppress_emit", got, want)
    for key in s0:
        _assert_equal(torch, f"suppress_close.{key}", sk[key], sp[key])
    cand = s0["occ"] & s0["dirty"] & ~s0["emitted"]
    n_emit = int(got.sum())
    n_evict = int((s0["occ"] & ~sk["occ"]).sum())
    n_cand = int(cand.sum())
    require(n_emit > 0 and n_evict > 0,
            f"suppress_close: data should emit ({n_emit}) and evict ({n_evict})")
    lanes, n = active.shape[0], cm_emit.shape[0]
    touched = int(torch.unique(slots[active]).numel())
    work = _clone(s0)
    ncomp_b = 16
    rec = measure(
        torch, "suppress_close", lambda: sup.suppress_close(work, *args),
        lambda: sup.suppress_close_plain(work, *args),
        lanes * (4 + 1) + touched * 16 + (capacity + 1) * (3 + 1) + n * 8 + n_cand * 8
        + n_emit * 2 + n_evict * (3 + 8 + ncomp_b), (capacity + 1) * 4 + n_cand * 17 * 3,
        reset=lambda: _restore(work, s0), per_call=per_call)
    return sk, rec, (f"{lanes} lanes, {capacity + 1} slots, {n_cand} candidates: {n_emit} emit, "
                     f"{n_evict} evicted"), n_cand - n_emit - n_evict


def phase_suppress_kernels(torch, seed, n=N_ROWS, capacity=STORE):
    """Phase 2f: K17 (tumbling lanes and k = 3 expansion lanes), K18, K19,
    K4's suppress mode and K1 without its grace cut against their twins on
    ``make_suppress_case`` at the flagship's shapes; then K17 and K18 at
    the shapes the main paths give them: phase 12h's (HOP_ROWS rows, 15 min
    advance, k = 4: K17's expansion mode and K18 over its lanes) and phase
    12g's (FINAL_GROW_ROWS rows: K17's tumbling mode and K18).  All exact.
    Returns ``({kernel: {mode: record}}, {shape: record})``."""
    from ksql_tpu_torch.ops import hash_store as hs
    from ksql_tpu_torch.ops import suppress as sup

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(seed + 11)
    c = make_suppress_case(torch, rng, dev, n, capacity)
    layout = c["layout"]
    recs: dict = {}
    extra: dict = {}
    grace = FINAL_GRACE_MS

    def done(kernel, mode, rec, what, tag=None):
        rec = dict(rec, max_abs_err=0.0)
        if tag is None:
            recs.setdefault(kernel, {})[mode] = rec
        else:
            extra[f"{kernel}[{mode}]@{tag}"] = rec
        where = "" if tag is None else f" at phase {tag}'s shape"
        lib = ("yardstick two torch.cummax over the masked lanes and rows" if kernel == "suppress_clock"
               else "no single PyTorch call computes it")
        _report("2f", f"{kernel}[{mode}]{where} ({what}; {lib})", rec)

    # ---- K1 without its grace cut (the EMIT FINAL route's tumbling mode)
    keys = torch.from_numpy(rng.integers(-(1 << 62), 1 << 62, (1, n))).to(dev)
    kvalid = torch.from_numpy(rng.random((1, n)) > 0.01).to(dev)
    for adv in (0, 20 * 60_000):
        args = (keys, kvalid, c["ts"], c["act_rows"], HOUR_MS, grace, None, capacity)
        _assert_tree(torch, f"row_prologue[no cut, advance {adv}]",
                     list(hs.row_prologue(*args, advance_ms=adv)),
                     list(hs.row_prologue_plain(*args, advance_ms=adv)))

    # ---- K17 on the tumbling lanes and on the k = 3 expansion lanes
    cm_emit = None
    for mode in ("tumbling", "expansion"):
        got, rec, what = _check_suppress_clock(torch, c, mode, grace)
        done("suppress_clock", mode, rec, what)
        if mode == "tumbling":
            cm_emit = got[2]

    # ---- K18: the born scatter and the close decision over 2^20 slots
    sk, rec, what, waiting = _check_suppress_close(torch, c, c["slots"], c["act_rows"], cm_emit, grace)
    require(waiting > 0, "suppress_close: some candidates should keep waiting")
    done("suppress_close", "tumbling", rec, what)

    # ---- K17 and K18 at the main paths' shapes: 12h (k = 4), 12g (2^20 rows)
    for tag, rows, mode in (("12h", HOP_ROWS, "expansion"), ("12g", FINAL_GROW_ROWS, "tumbling")):
        cs = make_suppress_case(torch, np.random.default_rng(seed + 12), dev, rows, capacity,
                                advance=HOP_ADVANCE_MS)
        got, rec, what = _check_suppress_clock(torch, cs, mode, grace)
        done("suppress_clock", mode, rec, what, tag)
        slots = cs["hop_slots"] if mode == "expansion" else cs["slots"]
        _sk, rec, what, _w = _check_suppress_close(torch, cs, slots, got[0], got[2], grace)
        done("suppress_close", "tumbling", rec, what, tag)
        del cs, _sk

    # ---- K19: one HAVING filter's verdicts over 65,536 lanes
    hp0 = c["hpass"]
    hk, hpl = hp0.clone(), hp0.clone()
    hargs = (c["hslots"], c["hmask"], c["hdata"], c["hvalid"])
    got = sup.having_verdict(hk, *hargs)
    want = sup.having_verdict_plain(hpl, *hargs)
    _assert_tree(torch, "having_verdict", list(got), list(want))
    _assert_equal(torch, "having_verdict.hpass", hk, hpl)
    n_tomb = int(got[1].sum())
    require(n_tomb > 0 and bool(got[0].any()), "having_verdict: data should pass and retract")
    masked = int(c["hmask"].sum())
    hw = hp0.clone()
    done("having_verdict", "tumbling", measure(
        torch, "having_verdict", lambda: sup.having_verdict(hw, *hargs),
        lambda: sup.having_verdict_plain(hw, *hargs),
        n * (4 + 1 + 1 + 1) + masked * 1 + n * 2 + masked * 1 + 1, n * 8,
        reset=lambda: hw.copy_(hp0)),
        f"{n} lanes, {masked} masked, {n_tomb} tombstones")

    # ---- K4's suppress mode: the store after K18, the stream time 4 h on
    e0 = _clone(sk)
    e0["max_ts"].fill_(int(cm_emit[-1]) + 4 * HOUR_MS)
    rec, expired, ek = check_evict(torch, layout, e0, FINAL_RETENTION_MS, suppress=True)
    kept = int((e0["occ"] & e0["dirty"] & ek["occ"]).sum())
    require(expired > 0 and kept > 0, "evict[suppress]: data should expire slots and keep dirty ones")
    done("evict", "suppress", rec, f"{expired} slots expired, {kept} dirty past retention kept")
    return recs, extra


def final_reference(url_idx, ts, rows, flush_to, size=HOUR_MS, grace=0, retention=HOUR_MS):
    """The sink of an EMIT FINAL tumbling COUNT(*) per URL, by numpy, for
    non-decreasing timestamps with every row valid (the per-row stream
    time is then the row's own ts): a window emits in the batch of the
    first row at or past its close (end + grace) if that row's ts is at or
    before its horizon (start + retention), is evicted unemitted there if
    not, and emits at the flush when no row reaches its close (and the
    flush does).  Within a batch, and at the flush, by window start, then
    by the first row of the (URL, window).  Returns the records (key, value
    dict, ts, window), the decision batch of each window start and the
    emitted and evicted window counts."""
    n = ts.size
    ws = ts - ts % size
    order = np.lexsort((np.arange(n), url_idx, ws))
    w_s, u_s, t_s = ws[order], url_idx[order], ts[order]
    head = np.ones(n, bool)
    head[1:] = (w_s[1:] != w_s[:-1]) | (u_s[1:] != u_s[:-1])
    idx = np.nonzero(head)[0]
    cnt = np.diff(np.append(idx, n))
    maxts = np.maximum.reduceat(t_s, idx)
    first = order[idx]
    win, url = w_s[idx], u_s[idx]
    pos = np.searchsorted(ts, win + size + grace)
    decided = pos < n
    emit = decided & (ts[np.minimum(pos, n - 1)] <= win + retention)
    flushed = ~decided & (win + size + grace <= flush_to)
    batch = np.where(decided, pos // rows, -1)
    out = []
    for sel in [emit & (batch == b) for b in range(-(-n // rows))] + [flushed]:
        for j in np.nonzero(sel)[0][np.lexsort((first[sel], win[sel]))]:
            out.append((f"/page/{url[j]}", {"CNT": int(cnt[j])}, int(maxts[j]),
                        (int(win[j]), int(win[j]) + size)))
    closing = set(batch[decided].tolist())
    return out, closing, int(emit.sum()), int((decided & ~emit).sum())


def check_final_sink(broker, topic, url_idx, ts, rows, flush_to, label):
    """The card's sink against :func:`final_reference`, record for record;
    every (key, window) at most once."""
    got = [(k, json.loads(v), t, tuple(w)) for k, v, t, w in sink_records(broker, topic)]
    want, closing, n_emit, n_evict = final_reference(url_idx, ts, rows, flush_to)
    require(len({(k, w) for k, _v, _t, w in got}) == len(got), f"{label}: a window emitted twice")
    require(got == want, f"{label}: the sink differs from the numpy EMIT FINAL reference "
            f"({len(got)} records vs {len(want)}, first difference at "
            f"{next((i for i, (a, b) in enumerate(zip(got, want)) if a != b), min(len(got), len(want)))})")
    return closing, n_emit, n_evict


def phase_final_e2e(torch, final_json, seed):
    """Phase 12: BASELINE #1 with EMIT FINAL and no grace
    (``ksql_tpu_torch/plans/pv_counts_final.json``) over phase 3's traffic
    at 16 batches (16 x 65,536 records of 50,000 zipf(1.3) URLs, 17 ms
    apart) into 2^20
    slots, then ``flush_time(last ts + 1 h)``: the sink must equal
    :func:`final_reference` record for record.  Its breakdown (12b) is
    taken on this run: an EMIT FINAL plan is never pipelined, so the
    breakdown's synchronized device steps change no overlap, and its
    16 batches include those that emit.  Returns the phase's record and
    the breakdown."""
    rng = np.random.default_rng(seed + 1)
    n = N_BATCHES * N_ROWS
    url_idx = rng.zipf(1.3, size=n).astype(np.int64) % N_URLS
    ts = TS0 + np.arange(n, dtype=np.int64) * PV_STEP_MS
    flush_to = int(ts[-1]) + HOUR_MS
    torch.cuda.reset_peak_memory_stats()
    batch_s = []
    run = []

    def drive():
        run.append(run_main_path(torch, final_json, url_idx, ts, DEVICE, STORE, batch_s, path="12",
                                 finish=lambda e: e.flush_time(flush_to)))
        return run[0][2]

    breakdown = phase_breakdown(torch, drive, N_BATCHES, "12b")
    broker, ex, secs = run[0]
    peak = torch.cuda.max_memory_allocated()
    q = ex.query
    require(q.suppress and not q.pipeline and q.grace_ms == 0, "12: not the EMIT FINAL route")
    require(int(q.state["overflow"]) == 0, "12: store overflowed")
    closing, n_emit, n_evict = check_final_sink(broker, "PV_COUNTS_FINAL", url_idx, ts, N_ROWS,
                                                flush_to, "12")
    require(n_emit > 0 and n_evict > 0, f"12: {n_emit} windows emitted in a batch, {n_evict} evicted")
    ms = np.array(batch_s) * 1e3
    close_ms = ms[sorted(closing)]
    open_ms = np.delete(ms, sorted(closing))
    pc = np.percentile(close_ms, [50, 99])
    po = np.percentile(open_ms, [50, 99])
    rec = len(sink_records(broker, "PV_COUNTS_FINAL"))
    print(f"[12] EMIT FINAL flagship: {n} events in {secs:.3f} s = {n / secs:.1f} events/s (flush "
          f"included, under 12b's timers and profiler); {rec} sink records equal the numpy "
          f"reference, each window once ({n_emit} "
          f"emitted in a batch, {n_evict} evicted unemitted past their horizon, the rest at the "
          f"flush); {len(close_ms)} batches close windows: p50 {pc[0]:.3f} ms p99 {pc[1]:.3f} ms; "
          f"{len(open_ms)} do not: p50 {po[0]:.3f} ms p99 {po[1]:.3f} ms; peak device memory "
          f"{peak} B; overflow 0")
    return dict(events_per_s=n / secs, closing_p50_ms=pc[0], closing_p99_ms=pc[1],
                open_p50_ms=po[0], open_p99_ms=po[1], sink_records=rec, emitted_in_batch=n_emit,
                evicted=n_evict, peak_bytes=peak), breakdown


def phase_final_growth(torch, final_json, seed):
    """Phase 12g: phase 4's 48 h traffic shape (an hour-local pool of URLs,
    each seen FINAL_GROW_REPEATS times an hour on average; ~160,000 (URL, hour)
    keys) on the EMIT FINAL plan, from a 2^20-slot store.  An EMIT FINAL
    batch is never pipelined, so the load check's headroom is one batch,
    and the windows leave retention an hour after they start: at phase 4's
    131,072-row batches the store would never pass its trigger.  With
    batches of 2^20 rows the first check passes it: K4's suppress mode
    frees the emitted windows, the compaction drops the graves, and the
    store grows to 2^21 carrying ``born`` and ``emitted``; the last
    quarter batch runs on the grown store.  The sink must equal
    :func:`final_reference`."""
    rng = np.random.default_rng(seed + 2)
    n = FINAL_GROW_RECORDS
    ts = TS0 - TS0 % HOUR_MS + (np.arange(n, dtype=np.int64) * (48 * HOUR_MS)) // n
    hour = (ts - ts[0]) // HOUR_MS
    pool = max(1, n // 48 // FINAL_GROW_REPEATS)
    url_idx = hour * pool + rng.integers(0, pool, n)
    flush_to = int(ts[-1]) + HOUR_MS
    torch.cuda.reset_peak_memory_stats()
    broker, ex, secs = run_main_path(torch, final_json, url_idx, ts, DEVICE, STORE,
                                     rows=FINAL_GROW_ROWS, path="12g",
                                     finish=lambda e: e.flush_time(flush_to))
    q = ex.query
    require(q.evictions >= 1, "12g: the retention pass never ran")
    require(q.grows >= 1 and q.store_capacity == 2 * STORE, f"12g: store at {q.store_capacity} slots")
    require(int(q.state["overflow"]) == 0, "12g: store overflowed")
    _closing, n_emit, n_evict = check_final_sink(broker, "PV_COUNTS_FINAL", url_idx, ts,
                                                 FINAL_GROW_ROWS, flush_to, "12g")
    rec = len(sink_records(broker, "PV_COUNTS_FINAL"))
    print(f"[12g] EMIT FINAL growth: {n} events in batches of {FINAL_GROW_ROWS} in {secs:.3f} s; "
          f"{q.evictions} retention passes, {q.compactions} compactions, {q.grows} grows -> "
          f"{q.store_capacity} slots; host rebuild seconds {[round(x, 4) for x in q.rebuild_seconds]}; "
          f"{rec} sink records ({n_emit} emitted in a batch, {n_evict} evicted) equal the numpy "
          f"reference; peak device memory {torch.cuda.max_memory_allocated()} B; overflow 0")
    return dict(seconds=secs, grows=q.grows, rebuild_s=q.rebuild_seconds, sink_records=rec)


def phase_final_hop(torch, hop_final_json, seed):
    """Phase 12h: BASELINE #2 with EMIT FINAL
    (``ksql_tpu_torch/plans/pv_stats_hopping_final.json``) over phase 8's
    traffic into 2^20 slots: the expansion route (the reference's reason),
    then ``flush_time(last ts + 1 h)``; the sink must equal the port's CPU
    run."""
    url_idx, uid, ts = hop_traffic(seed)
    n = url_idx.size
    flush_to = int(ts[-1]) + HOUR_MS
    batch_s = []
    broker, ex, secs = run_main_path(torch, hop_final_json, url_idx, ts, DEVICE, STORE, batch_s,
                                     rows=HOP_ROWS, user_ids=uid, path="12h",
                                     finish=lambda e: e.flush_time(flush_to))
    q = ex.query
    require(not q.sliced and q.expansion == 4 and "EMIT FINAL" in (q.windowing_fallback or ""),
            "12h: expected the expansion route with the EMIT FINAL reason")
    require(int(q.state["overflow"]) == 0, "12h: store overflowed")
    cpu_broker, _ex, cpu_secs = run_main_path(torch, hop_final_json, url_idx, ts, "cpu", STORE,
                                              rows=HOP_ROWS, user_ids=uid,
                                              finish=lambda e: e.flush_time(flush_to))
    got = sink_records(broker, "PV_STATS_FINAL")
    require(got == sink_records(cpu_broker, "PV_STATS_FINAL"), "12h: card sink differs from the CPU run")
    require(len({(k, w) for k, _v, _t, w in got}) == len(got), "12h: a window emitted twice")
    p50, p99 = np.percentile(np.array(batch_s) * 1e3, [50, 99])
    print(f"[12h] BASELINE #2 EMIT FINAL, expansion route: {n} events in {secs:.3f} s = "
          f"{n / secs:.1f} events/s; batch p50 {p50:.3f} ms p99 {p99:.3f} ms; {len(got)} sink records, "
          f"each window once, equal the CPU run ({cpu_secs:.3f} s); overflow 0")
    return dict(events_per_s=n / secs, p50_ms=p50, p99_ms=p99, sink_records=len(got))


def having_traffic(seed, n_batches=N_BATCHES):
    """Phase 3's URLs and timestamps, with USER_ID uniform in 1..999 as
    ``bench.py:_pv_batches`` draws it."""
    rng = np.random.default_rng(seed + 1)
    n = n_batches * N_ROWS
    url_idx = rng.zipf(1.3, size=n).astype(np.int64) % N_URLS
    uid = np.random.default_rng(seed + 13).integers(1, 1000, n)
    return url_idx, uid, TS0 + np.arange(n, dtype=np.int64) * PV_STEP_MS


def fraud_reference(url_idx, ts, rows, limit=3):
    """possible_fraud's sink by numpy: per batch, one row per (URL, minute)
    the batch touched whose count so far passes ``limit``, with that count
    and the window's last ts so far, in ts order (every row valid,
    timestamps increasing: no tombstone can occur)."""
    n = ts.size
    key = (ts - ts % HAVING_MIN_MS) * N_URLS + url_idx
    out = []
    counts: dict = {}
    for b in range(0, n, rows):
        k, t = key[b:b + rows], ts[b:b + rows]
        uk, inv = np.unique(k, return_inverse=True)
        c = np.bincount(inv)
        last = np.zeros(uk.size, np.int64)
        last[inv] = t  # timestamps increase: the last write is the max
        rows_b = []
        for kk, cc, tt in zip(uk.tolist(), c.tolist(), last.tolist()):
            total = counts.get(kk, 0) + cc
            counts[kk] = total
            if total > limit:
                ws = kk // N_URLS
                rows_b.append((tt, f"/page/{kk % N_URLS}", total, ws))
        rows_b.sort()
        out += [(u, {"CNT": cnt}, tt, (ws, ws + HAVING_MIN_MS)) for tt, u, cnt, ws in rows_b]
    return out


def phase_having_e2e(torch, fraud_json, retract_json, seed):
    """Phases 13 and 13r: ksqlDB's possible_fraud query over the page views
    (``ksql_tpu_torch/plans/possible_fraud.json``, COUNT(*) > 3 per URL and
    minute) on phase 3's traffic: the sink must equal
    :func:`fraud_reference` with no tombstone; then a verdict that flips
    both ways (``pv_having_retract.json``, AVG(USER_ID) > 500) on the same
    traffic, cut to its first HAVING_RETRACT_BATCHES batches: the sink must
    hold retraction tombstones and equal the port's CPU run over the same
    batches record for record."""
    url_idx, uid, ts = having_traffic(seed, HAVING_BATCHES)
    n = url_idx.size
    out = {}
    # 13r runs the first HAVING_RETRACT_BATCHES batches of it
    k = HAVING_RETRACT_BATCHES * N_ROWS
    r_url, r_uid, r_ts = url_idx[:k], uid[:k], ts[:k]
    batch_s = []
    broker, ex, secs = run_main_path(torch, fraud_json, url_idx, ts, DEVICE, STORE, batch_s,
                                     user_ids=uid, path="13")
    q = ex.query
    require("hpass" in q.state and q.pipeline, "13: not the HAVING retraction route")
    require(int(q.state["overflow"]) == 0 and q.grows == 0, "13: store overflowed or grew")
    got = [(k, None if v is None else json.loads(v), t, tuple(w))
           for k, v, t, w in sink_records(broker, "POSSIBLE_FRAUD")]
    want = fraud_reference(url_idx, ts, N_ROWS)
    require(got == want, f"13: the sink differs from the numpy reference ({len(got)} vs {len(want)})")
    p50, p99 = np.percentile(np.array(batch_s) * 1e3, [50, 99])
    slots = int(q.state["occ"].sum())
    print(f"[13] possible_fraud (HAVING COUNT(*) > 3): {n} events in {secs:.3f} s = {n / secs:.1f} "
          f"events/s; batch p50 {p50:.3f} ms p99 {p99:.3f} ms; {len(got)} sink records equal the numpy "
          f"reference, 0 tombstones; {slots} (URL, minute) slots of {q.store_capacity}")
    out["possible_fraud"] = dict(events_per_s=n / secs, p50_ms=p50, p99_ms=p99, sink_records=len(got),
                                 slots=slots)
    batch_s = []
    broker, ex, secs = run_main_path(torch, retract_json, r_url, r_ts, DEVICE, STORE, batch_s,
                                     user_ids=r_uid, path="13r")
    got = sink_records(broker, "PV_HAVING_RETRACT")
    tombs = sum(v is None for _k, v, _t, _w in got)
    require(tombs > 0, "13r: the flipping verdict emitted no tombstone")
    cpu_broker, _ex, cpu_secs = run_main_path(torch, retract_json, r_url, r_ts, "cpu", STORE,
                                              user_ids=r_uid)
    require(got == sink_records(cpu_broker, "PV_HAVING_RETRACT"),
            f"13r: card sink differs from the CPU run over {HAVING_RETRACT_BATCHES} batches")
    p50, p99 = np.percentile(np.array(batch_s) * 1e3, [50, 99])
    print(f"[13r] HAVING AVG(USER_ID) > 500: {r_ts.size} events in {secs:.3f} s = {r_ts.size / secs:.1f} "
          f"events/s; batch "
          f"p50 {p50:.3f} ms p99 {p99:.3f} ms; {len(got)} sink records ({tombs} retraction tombstones) "
          f"equal the CPU run ({cpu_secs:.3f} s)")
    out["having_retract"] = dict(events_per_s=r_ts.size / secs, p50_ms=p50, p99_ms=p99, sink_records=len(got),
                                 tombstones=tombs, cpu_s=cpu_secs)
    return out


# ------------------------------------------------------- phase 2v, 14-14b
VEC_ROWS = 4096  # phase 14's batch: 16,384 and 8,192 overflow the clamped store (PERF.md §4)
VEC_BATCHES = 8  # 8 x 4,096 records (cut from 64, 32 and 16 for the script's time; still 2 grows)
VEC_STORE = 1 << 16  # phase 2v's store: the size phase 14 grows to
HIST_STORE = 1 << 15  # phase 2v's histogram store: the size phase 14h grows to
VEC_FILL = 0.5  # phase 2v's stores are half full
_PLANS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "ksql_tpu_torch", "plans")
VEC_PLAN = os.path.join(_PLANS, "pv_vectors.json")
HIST_PLAN = os.path.join(_PLANS, "pv_user_pages.json")
VEC_BREAKDOWN_BATCHES = 4  # phase 14b's re-run (cut from 8 with phase 14)


def vector_traffic(seed, n_batches=VEC_BATCHES):
    """Phase 6's traffic (``bench.py:119-146``: 50,000 URLs zipf(1.3),
    USER_ID 1..999, 17 ms apart; the same draws as :func:`hop_traffic`) in
    ``n_batches`` batches of VEC_ROWS."""
    return _pv_draw(np.random.default_rng(seed + 3), n_batches * VEC_ROWS)


def _pv_draw(rng, n):
    """``n`` records of phase 6's traffic shape: (URL index, USER_ID, ts)."""
    url_idx = rng.zipf(1.3, size=n).astype(np.int64) % N_URLS
    return url_idx, rng.integers(1, 1000, n), TS0 + np.arange(n, dtype=np.int64) * 17


def _bits(torch, t):
    return t.view(torch.int64) if t.dtype == torch.float64 else t


def _assert_store(torch, name, got, want, keys):
    for k in keys:
        _assert_equal(torch, f"{name}.{k}", _bits(torch, got[k]), _bits(torch, want[k]))


def _vector_query(torch, plan_path, rows, capacity, dev):
    """The plan's query, its store layout at ``capacity`` slots (the budget
    clamp is for a fresh query; a grown store holds more) and a fresh
    store."""
    import dataclasses

    from ksql_tpu_torch.execution.steps import plan_from_json
    from ksql_tpu_torch.ops import hash_store as hs
    from ksql_tpu_torch.runtime.lowering import TorchCompiledQuery

    with open(plan_path) as f:
        q = TorchCompiledQuery(plan_from_json(json.load(f)), capacity=rows,
                               store_capacity=capacity, device=dev)
    layout = dataclasses.replace(q.store_layout, capacity=capacity)
    return q, layout, hs.init_store(layout, dev)


def make_vector_case(torch, rng, dev, n=VEC_ROWS, capacity=VEC_STORE):
    """Phase 2v's pv_vectors case: a ``capacity``-slot store, VEC_FILL of its
    slots holding vector state — collect lists below, at and past their cap
    of 1,000, sets of distinct ids, E3/L3 counts up to 10 (L3's ring
    mid-wrap), sorted top-3s with absent entries — and a populated dump row;
    one batch of ``n`` rows of phase 14's traffic whose URLs map onto the
    filled slots (hot URLs repeat within the batch), 2% of the rows
    overflowed to the dump slot and 1% inactive.  Returns the query, layout,
    store, slots, per-component contributions and the group starts."""
    from ksql_tpu_torch.common import types as T
    from ksql_tpu_torch.compiler.torch_expr import DCol

    q, layout, store = _vector_query(torch, VEC_PLAN, n, capacity, dev)
    c1 = capacity + 1
    filled = rng.choice(capacity, int(capacity * VEC_FILL), replace=False)
    starts = q._spec_comp_starts()
    for spec, j in zip(q.agg_specs, starts):
        comps = spec.device.components
        K = comps[-1].width
        if comps[0].combine == "vec_count":
            if K == 1000:
                cnt = np.where(rng.random(c1) < 0.6, rng.integers(1, 50, c1),
                               rng.choice([500, 999, 1000, 1001, 2500], c1))
            else:
                cnt = rng.integers(0, 11, c1)
            cnt[np.setdiff1d(np.arange(capacity), filled)] = 0
            cnt[capacity] = 0
            if comps[1].mode == "set":
                # distinct ids: an offset plus 2 t modulo 999 (2 and 999 are coprime)
                cnt = np.minimum(cnt, 999)
                data = (rng.integers(0, 999, (c1, 1)) + 2 * np.arange(K)[None, :]) % 999 + 1
            else:
                data = rng.integers(1, 1000, (c1, K))
            held = np.arange(K)[None, :] < np.minimum(cnt, K)[:, None]
            held[capacity] = True  # the dump row holds whatever was aimed at it
            store[f"a{j}"].copy_(torch.from_numpy(cnt.astype(np.int64)))
            store[f"a{j + 1}"].copy_(torch.from_numpy(np.where(held, data, 0).astype(np.int64)))
            store[f"a{j + 2}"].copy_(torch.from_numpy(held.astype(np.int8)))
        else:  # TOPK / TOPKDISTINCT: sorted descending, absent entries at the floor
            cnt = rng.integers(0, 6, c1)
            top = -np.sort(-rng.integers(1, 1000, (c1, K)), axis=1)
            top = np.where(np.arange(K)[None, :] < cnt[:, None], top, np.iinfo(np.int64).min)
            store[f"a{j}"].copy_(torch.from_numpy(cnt.astype(np.int32)))
            store[f"a{j + 1}"].copy_(torch.from_numpy(top.astype(np.int64)))
    url_idx, uid, ts = _pv_draw(rng, n)
    slots = filled[(url_idx * 2654435761) % filled.size].astype(np.int32)
    over = rng.random(n) < 0.02
    slots[over] = capacity
    active = torch.from_numpy(rng.random(n) > 0.01).to(dev)
    slots = torch.from_numpy(slots).to(dev)
    uid_t = torch.from_numpy(uid.astype(np.int64)).to(dev)
    col = DCol(uid_t, torch.ones(n, dtype=torch.bool, device=dev), T.BIGINT)
    contribs = [torch.from_numpy(ts).to(dev)]
    for spec in q.agg_specs:
        contribs.extend(spec.device.contribs([col], active))
    return dict(q=q, layout=layout, store=store, slots=slots, contribs=contribs, starts=starts,
                active=active)


def make_hist_case(torch, rng, dev, n=VEC_ROWS, capacity=HIST_STORE):
    """Phase 2v's pv_user_pages case: a ``capacity``-slot HISTOGRAM store,
    VEC_FILL of it holding up to 300 entries a slot (a few at the cap of
    1,000) of URL codes with counts, a populated dump row; one batch of
    phase 14h's traffic: (USER_ID, hour) slots, URL codes, 2% overflowed."""
    from ksql_tpu_torch.common import types as T
    from ksql_tpu_torch.common.batch import stable_hash64
    from ksql_tpu_torch.compiler.torch_expr import DCol

    q, layout, store = _vector_query(torch, HIST_PLAN, n, capacity, dev)
    (j,) = q._spec_comp_starts()
    K = layout.components[j + 1].width
    c1 = capacity + 1
    filled = rng.choice(capacity, int(capacity * VEC_FILL), replace=False)
    codes = np.array([stable_hash64(f"/page/{i}") for i in range(2000)], np.int64)
    cnt = np.zeros(c1, np.int64)
    cnt[filled] = np.where(rng.random(filled.size) < 0.02, K, rng.integers(1, 300, filled.size))
    cnt[capacity] = 0
    held = np.arange(K)[None, :] < cnt[:, None]
    held[capacity] = True
    # distinct codes: an offset plus 7 t modulo 2,000 (7 and 2,000 are coprime)
    data = codes[(rng.integers(0, 2000, (c1, 1)) + 7 * np.arange(K)[None, :]) % 2000]
    store[f"a{j}"].copy_(torch.from_numpy(cnt))
    store[f"a{j + 1}"].copy_(torch.from_numpy(np.where(held, data, 0)))
    store[f"a{j + 2}"].copy_(torch.from_numpy(held.astype(np.int8)))
    store[f"a{j + 3}"].copy_(torch.from_numpy(np.where(held, rng.integers(1, 50, (c1, K)), 0)))
    url_idx, uid, ts = _pv_draw(rng, n)
    slots = filled[(uid * 40503) % filled.size].astype(np.int32)
    slots[rng.random(n) < 0.02] = capacity
    url_codes = codes[url_idx % codes.size]
    active = torch.from_numpy(rng.random(n) > 0.01).to(dev)
    col = DCol(torch.from_numpy(url_codes).to(dev), torch.ones(n, dtype=torch.bool, device=dev),
               T.STRING)
    contribs = [torch.from_numpy(ts).to(dev)] + q.agg_specs[0].device.contribs([col], active)
    return dict(q=q, layout=layout, store=store, slots=torch.from_numpy(slots).to(dev),
                contribs=contribs, j=j)


#: K21's batches on phase 2v's case (``topk_skew``): phase 2v's own; no
#: row aimed at the dump slot and none holding the sentinel (the dump row's
#: merge reads a real slot); the hottest slot holding a quarter of the
#: batch (phase 3's zipf skew); every row alone in its slot (the dump row
#: untouched)
TOPK_SKEWS = ("2v", "no dump", "hot quarter", "alone")


def topk_skew(torch, c, j, kind, rng):
    """One TOPK_SKEWS batch, ``(slots, values)``, for the top-K column at
    component ``j`` of ``make_vector_case``'s case ``c``."""
    cap = c["layout"].capacity
    sent = c["layout"].components[j].init
    slots = c["slots"].cpu().numpy().copy()
    vals = c["contribs"][j].cpu().numpy().copy()
    n = slots.size
    if kind == "no dump":
        live = np.unique(slots[(slots != cap) & (vals != sent)])
        off = (slots == cap) | (vals == sent)
        slots[off] = live[rng.integers(0, live.size, int(off.sum()))]
        vals[off] = rng.integers(1, 1000, int(off.sum()))
    elif kind == "hot quarter":
        hot = np.bincount(slots[slots != cap]).argmax()
        slots[rng.permutation(n)[: n // 4]] = hot
    elif kind == "alone":
        slots = rng.choice(cap, n, replace=False).astype(np.int32)
        vals = rng.integers(1, 1000, n).astype(vals.dtype)
    dev = c["slots"].device
    return torch.from_numpy(slots).to(dev), torch.from_numpy(vals).to(dev)


def check_vec_topk(torch, layout, store, j, vals, slots, tag, plain_reps=PLAIN_REPS):
    """K21 on the top-K column at component ``j`` of ``store`` against its
    twin on copies (exact, bits, the dump row included), then timed from
    the same column every launch.  Returns the record and what it saw."""
    from ksql_tpu_torch.ops import vector as vec

    key = f"a{j}"
    got, want, work = ({key: store[key].clone()} for _ in range(3))
    vec.vec_topk(got, layout, j, vals, slots)
    vec.vec_topk_plain(want, layout, j, vals, slots)
    _assert_store(torch, f"vec_topk[{tag}]", got, want, [key])
    cap, K = layout.capacity, layout.components[j].width
    n, esize = slots.shape[0], store[key].element_size()
    s_np, v_np = slots.cpu().numpy(), vals.cpu().numpy()
    live = (s_np != cap) & (v_np != layout.components[j].init)
    touched = np.unique(s_np[live]).size
    hot = int(np.bincount(s_np[live]).max()) if live.any() else 0
    rec = measure(torch, "vec_topk", lambda: vec.vec_topk(work, layout, j, vals, slots),
                  lambda: vec.vec_topk_plain(work, layout, j, vals, slots),
                  n * (4 + esize) + (touched + 1) * K * esize * 2, n * 40,
                  reset=lambda: work[key].copy_(store[key]), plain_reps=plain_reps)
    return dict(rec, max_abs_err=0.0), (f"{n} rows into {touched} slots, the hottest {hot} rows, "
                                        f"{n - int(live.sum())} at the dump slot or the sentinel")


def width_k_evict_case(torch, c, rng):
    """K4's tumbling mode over ``make_vector_case``'s store: the slots that
    hold vector state live, a quarter of them past the retention (1 h)."""
    st = _clone(c["store"])
    names = [spec.fname for spec in c["q"].agg_specs]
    cnt = st[f"a{c['starts'][names.index('COLLECT_LIST')]}"]  # the filled slots hold a list
    st["occ"].copy_(cnt > 0)
    st["wstart"].copy_(torch.from_numpy(rng.integers(0, 4, cnt.shape[0]) * HOUR_MS).to(cnt.device))
    st["max_ts"].fill_(HOUR_MS + 1)
    return st


def _changed_cells(torch, before, after, keys):
    """Cells of the listed columns that a fold changed (its writes)."""
    return sum(int((_bits(torch, before[k]) != _bits(torch, after[k])).sum()) for k in keys)


def phase_vector_kernels(torch, seed):
    """Phase 2v: K20 (append, set, ring, hist), K21 (plain, distinct), K22,
    K6's wide gather, K13 on the first-occurrence order and K4 over width-K
    columns against their twins on ``make_vector_case`` and
    ``make_hist_case``, and K21 over doubles with -0.0, +0.0, NaN and the
    floor; all exact, the dump row included.  Returns ``({kernel: {mode:
    record}}, extra records)``."""
    from ksql_tpu_torch.ops import hash_store as hs
    from ksql_tpu_torch.ops import session as sess
    from ksql_tpu_torch.ops import slicing
    from ksql_tpu_torch.ops import vector as vec

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(seed + 17)
    c = make_vector_case(torch, rng, dev)
    layout, store, slots, contribs = c["layout"], c["store"], c["slots"], c["contribs"]
    n, cap = slots.shape[0], layout.capacity
    recs: dict = {}
    extra: dict = {}
    s_np = slots.cpu().numpy()
    touched = np.unique(s_np[s_np != cap])

    def done(kernel, mode, rec, what):
        recs.setdefault(kernel, {})[mode] = dict(rec, max_abs_err=0.0)
        if rec["library_ms"] is None:
            what += "; no single PyTorch call computes it"
        _report("2v", f"{kernel}[{mode}] ({what})", recs[kernel][mode])

    def group_keys(j, size):
        return [f"a{j + t}" for t in range(size)]

    def check_fold(name, j, size, fn, plain):
        keys = group_keys(j, size)
        saved = {k: store[k].clone() for k in keys}
        work = {k: store[k].clone() for k in keys}
        twin = {k: store[k].clone() for k in keys}
        fn(work)
        plain(twin)
        torch.cuda.synchronize()
        _assert_store(torch, name, work, twin, keys)
        return saved, work, (lambda: [work[k].copy_(saved[k]) for k in keys])

    # ---- K20 append / set / ring (CL, CS, L3; E3 checked, timed with CL)
    names = [s.fname for s in c["q"].agg_specs]
    for fname, mode in (("COLLECT_LIST", "append"), ("COLLECT_SET", "set"),
                        ("LATEST_BY_OFFSET", "ring"), ("EARLIEST_BY_OFFSET", "append")):
        j = c["starts"][names.index(fname)]
        K = layout.components[j + 1].width
        saved, work, reset = check_fold(
            f"vec_collect[{mode}:{fname}]", j, 3,
            lambda s: vec.vec_collect(s, layout, j, contribs, slots, mode),
            lambda s: vec.vec_collect_plain(s, layout, j, contribs, slots, mode))
        if fname == "EARLIEST_BY_OFFSET":
            print(f"[2v] vec_collect[append] EARLIEST_BY_OFFSET(USER_ID, 3): exact")
            continue
        cnt = saved[f"a{j}"][torch.from_numpy(touched).to(dev)].clamp(max=K)
        scan = int(cnt.sum()) * 9 if mode == "set" else 0
        writes = _changed_cells(torch, saved, work, group_keys(j + 1, 2))
        done("vec_collect", mode, measure(
            torch, "vec_collect", lambda: vec.vec_collect(work, layout, j, contribs, slots, mode),
            lambda: vec.vec_collect_plain(work, layout, j, contribs, slots, mode),
            n * 21 + touched.size * 16 + scan + writes * 9, n * 40, reset=reset, plain_reps=10),
            f"{fname}, K = {K}: {n} rows into {touched.size} slots, {writes} cells written")
    # ---- K13 on the first-occurrence order (COLLECT_SET's, as K20 sorts it)
    j = c["starts"][names.index("COLLECT_SET")]
    eff0 = torch.where((contribs[j] > 0) & (slots != cap), slots, torch.full_like(slots, cap))
    k1 = eff0.long() * 2 + contribs[j + 2].long()
    k2 = contribs[j + 1].long()
    _assert_equal(torch, "seg_sort[vector]", sess.seg_sort(k1, k2), sess.seg_sort_plain(k1, k2))
    extra["seg_sort_vector"] = dict(measure(
        torch, "seg_sort", lambda: sess.seg_sort(k1, k2), lambda: sess.seg_sort_plain(k1, k2),
        n * 20, n * int(np.ceil(np.log2(n))) * 5, library=lambda: _argsort_lsd(torch, k1, k2)),
        max_abs_err=0.0)
    _report("2v", f"seg_sort[vector] ({n} rows, (slot, bit, value); yardstick two stable torch.argsort)",
            extra["seg_sort_vector"])
    # ---- K21 plain / distinct (TK, TD), at phase 2v's batch and its skews
    for fname, mode in (("TOPK", "plain"), ("TOPKDISTINCT", "distinct")):
        j = c["starts"][names.index(fname)] + 1
        K = layout.components[j].width
        for kind in TOPK_SKEWS:
            tslots, tvals = (slots, contribs[j]) if kind == "2v" else topk_skew(torch, c, j, kind, rng)
            rec, what = check_vec_topk(torch, layout, store, j, tvals, tslots, f"{mode} {kind}", plain_reps=5)
            done("vec_topk", mode if kind == "2v" else f"{mode} {kind}", rec, f"{fname}(USER_ID, {K}): {what}")
    _check_topk_doubles(torch, rng, dev)
    # ---- K6's wide gather over the winners
    rowidx = torch.arange(n, dtype=torch.int32, device=dev)
    first = torch.full((cap + 1,), n, dtype=torch.int32, device=dev)
    first.scatter_reduce_(0, torch.where(c["active"], slots, cap).long(), rowidx, "amin")
    winners = c["active"] & (slots != cap) & (first[slots.long()] == rowidx)  # K3's winners
    got = slicing.combine_windows(store, layout, 1, slots, mask=winners)
    want = slicing.combine_windows_plain(store, layout, 1, slots, mask=winners)
    for k in want:
        g, w = got[k], want[k]
        if g.dim() == 2:
            g, w = g[winners], w[winners]
        _assert_equal(torch, f"combine_windows[wide].{k}", _bits(torch, g), _bits(torch, w))
    wide = [store[f"a{j}"] for j, comp in enumerate(layout.components) if comp.width > 1]
    row_bytes = sum(w.shape[1] * w.element_size() for w in wide)
    lanes = int(winners.sum())
    sel = slots[winners].long()
    done("combine_windows", "wide", measure(
        torch, "combine_windows", lambda: slicing.combine_windows(store, layout, 1, slots, mask=winners),
        lambda: slicing.combine_windows_plain(store, layout, 1, slots, mask=winners),
        n * 5 + lanes * row_bytes * 2 + n * 60, 0,
        library=lambda: [torch.index_select(w, 0, sel) for w in wide]),
        f"{lanes} of {n} lanes gather {row_bytes} B of vector state; yardstick index_select of the "
        "K-wide rows")
    # ---- K4 over width-K columns: a quarter of the filled slots expire
    ev0 = width_k_evict_case(torch, c, rng)
    rec, expired, _ek = check_evict(torch, layout, ev0, HOUR_MS)
    require(expired > 0, "evict[width-K]: data should expire some slots")
    done("evict", "tumbling width-K", rec, f"{expired} of {int(ev0['occ'].sum())} slots expire, "
         f"{sum(store[f'a{j}'][0].numel() * store[f'a{j}'].element_size() for j in range(len(layout.components)))} B a slot")
    del ev0
    # ---- K20 hist + K22 (pv_user_pages)
    h = make_hist_case(torch, rng, dev)
    hl, hst, hslots, hc, j = h["layout"], h["store"], h["slots"], h["contribs"], h["j"]
    keys = [f"a{j + t}" for t in range(4)]
    saved = {k: hst[k].clone() for k in keys}
    work = {k: hst[k].clone() for k in keys}
    twin = {k: hst[k].clone() for k in keys}
    vec.vec_collect(work, hl, j, hc, hslots, "hist")
    vec.vec_collect_plain(twin, hl, j, hc, hslots, "hist")
    _assert_store(torch, "vec_collect[hist]", work, twin, keys)
    after1 = {k: work[k].clone() for k in keys}
    vec.vec_hist(work, hl, j, hc, hslots)
    vec.vec_hist_plain(twin, hl, j, hc, hslots)
    _assert_store(torch, "vec_hist", work, twin, keys)
    hs_np = hslots.cpu().numpy()
    htouched = np.unique(hs_np[hs_np != hl.capacity])
    hcnt = int(saved[f"a{j}"][torch.from_numpy(htouched).to(dev)].clamp(max=1000).sum())
    writes = _changed_cells(torch, saved, after1, keys[1:3])

    def reset1():
        for k in keys:
            work[k].copy_(saved[k])

    def reset2():
        for k in keys:
            work[k].copy_(after1[k])

    done("vec_collect", "hist", measure(
        torch, "vec_collect", lambda: vec.vec_collect(work, hl, j, hc, hslots, "hist"),
        lambda: vec.vec_collect_plain(work, hl, j, hc, hslots, "hist"),
        n * 21 + htouched.size * 16 + hcnt * 9 + writes * 9, n * 40, reset=reset1, plain_reps=10),
        f"HISTOGRAM(URL): {n} rows into {htouched.size} slots, {writes} entries appended")
    bumped = _changed_cells(torch, after1, twin, keys[3:])
    done("vec_hist", "hist", measure(
        torch, "vec_hist", lambda: vec.vec_hist(work, hl, j, hc, hslots),
        lambda: vec.vec_hist_plain(work, hl, j, hc, hslots),
        n * 21 + htouched.size * 8 + hcnt * 9 + bumped * 16, n * 40, reset=reset2, plain_reps=10),
        f"{n} rows' counts into {bumped} entries")
    return recs, extra


def _check_topk_doubles(torch, rng, dev, capacity=1 << 10, n=VEC_ROWS, K=3):
    """K21 over DOUBLE values with -0.0, +0.0, NaN and the -inf floor, both
    modes, against the twin; exact (bits)."""
    from ksql_tpu_torch.ops import hash_store as hs
    from ksql_tpu_torch.ops import vector as vec

    pool = np.array([-0.0, 0.0, np.nan, -np.inf, 1.5, -2.0, 7.25, 1e300], np.float64)
    for mode in ("", "distinct"):
        layout = hs.StoreLayout(capacity, 1, (
            hs.AggComponent("add", "int32", 0),
            hs.AggComponent("topk", "float64", float("-inf"), width=K, mode=mode)))
        col = torch.from_numpy(-np.sort(-pool[rng.integers(0, pool.size, (capacity + 1, K))],
                                        axis=1)).to(dev)
        vals = torch.from_numpy(pool[rng.integers(0, pool.size, n)]).to(dev)
        slots = torch.from_numpy(rng.integers(0, capacity + 1, n).astype(np.int32)).to(dev)
        got, want = {"a1": col.clone()}, {"a1": col.clone()}
        vec.vec_topk(got, layout, 1, vals, slots)
        vec.vec_topk_plain(want, layout, 1, vals, slots)
        _assert_store(torch, f"vec_topk[{mode or 'plain'}:DOUBLE]", got, want, ["a1"])
    print("[2v] vec_topk over DOUBLE (-0.0, +0.0, NaN, -inf), plain and distinct: exact (bits)")


def vector_batch_loads(url_idx, ts, clamp=8192):
    """Per batch size, the load of pv_vectors' budget-clamped store when
    batch 4 inserts: the pipelined executor's first load check (batch 4)
    reads batch 3's occupancy, so nothing can grow the store before."""
    key = url_idx * (1 << 20) + ts // HOUR_MS
    return {rows: len(np.unique(key[: 4 * rows])) / clamp for rows in (16384, 8192, VEC_ROWS)}


def vector_reference(url_idx, uid, ts):
    """A dict model of pv_vectors: per (URL, hour) in arrival order, CL the
    first 1,000 USER_IDs, CS the first 1,000 distinct, TK/TD the 3 largest
    with and without repeats, E3/L3 the first and last 3."""
    groups: dict = {}
    for u, x, t in zip(url_idx.tolist(), uid.tolist(), ts.tolist()):
        groups.setdefault((f"/page/{u}", t - t % HOUR_MS), []).append(x)
    out = {}
    for k, xs in groups.items():
        distinct = list(dict.fromkeys(xs))
        out[k] = {"CL": xs[:1000], "CS": distinct[:1000], "TK": sorted(xs, reverse=True)[:3],
                  "TD": sorted(distinct, reverse=True)[:3], "E3": xs[:3], "L3": xs[-3:]}
    return out


def last_values(broker, topic):
    """The last sink value per (key, window start), decoded."""
    return {(k, w[0]): json.loads(v) for k, v, _t, w in sink_records(broker, topic)}


def _vector_e2e(torch, plan_json, topic, url_idx, uid, ts, tag):
    """One vector plan end to end on the card (launches held to
    ``PATH_KERNELS[tag]``) and on the CPU; the sinks must be equal."""
    n = url_idx.size
    torch.cuda.reset_peak_memory_stats()
    batch_s = []
    broker, ex, secs = run_main_path(torch, plan_json, url_idx, ts, DEVICE, STORE, batch_s,
                                     rows=VEC_ROWS, user_ids=uid, path=tag)
    peak = torch.cuda.max_memory_allocated()
    q = ex.query
    require(any(c.width > 1 for c in q.store_layout.components) and not q.sliced,
            f"{tag}: not the vector route")
    require(int(q.state["overflow"]) == 0, f"{tag}: store overflowed")
    cpu_broker, _ex, cpu_secs = run_main_path(torch, plan_json, url_idx, ts, "cpu", STORE,
                                              rows=VEC_ROWS, user_ids=uid)
    sink = sink_records(broker, topic)
    require(sink == sink_records(cpu_broker, topic), f"{tag}: card sink differs from the CPU run")
    p50, p99 = np.percentile(np.array(batch_s) * 1e3, [50, 99])
    rec = dict(events_per_s=n / secs, p50_ms=p50, p99_ms=p99, peak_bytes=peak, grows=q.grows,
               store_slots=q.store_capacity, rebuild_s=list(q.rebuild_seconds), sink_records=len(sink),
               cpu_s=cpu_secs)
    return broker, q, rec


def phase_vector_e2e(torch, vec_json, hist_json, seed):
    """Phases 14 and 14h: pv_vectors.json and pv_user_pages.json through
    ``run_plan`` over phase 6's traffic in VEC_BATCHES batches of VEC_ROWS
    records.  Each sink must equal the port's CPU run record for record,
    with no overflow; 14's store must grow, its last value per (URL, hour)
    equal :func:`vector_reference`, 14h's last map per (USER_ID, hour) a
    count of the URLs."""
    url_idx, uid, ts = vector_traffic(seed)
    n = url_idx.size
    out = {}
    broker, q, rec = _vector_e2e(torch, vec_json, "PV_VECTORS", url_idx, uid, ts, "14")
    require(q.grows >= 1, f"14: the store did not grow ({q.store_capacity} slots)")
    got = last_values(broker, "PV_VECTORS")
    want = vector_reference(url_idx, uid, ts)
    require(got == want, f"14: the last values differ from the dict model ({len(got)} vs {len(want)} keys)")
    hot = max(want.values(), key=lambda v: len(v["CS"]))
    loads = vector_batch_loads(url_idx, ts)
    print("[14] load of the 8,192-slot store when batch 4 inserts, by batch size: "
          + ", ".join(f"{r} rows {x:.3f}" for r, x in loads.items()))
    print(f"[14] pv_vectors: {n} events in batches of {VEC_ROWS}, {len(want)} (URL, hour) keys, "
          f"{rec['sink_records']} sink records; {rec['events_per_s']:.1f} events/s; batch p50 "
          f"{rec['p50_ms']:.3f} ms p99 {rec['p99_ms']:.3f} ms; peak device memory {rec['peak_bytes']} B; "
          f"store {q.store_capacity} slots after {q.grows} grows (host rebuild s "
          f"{[round(x, 4) for x in q.rebuild_seconds]}); the widest set holds {len(hot['CS'])} ids; "
          f"sink equals the CPU run ({rec['cpu_s']:.3f} s), last values equal the dict model, overflow 0")
    out["vectors"] = dict(rec, keys=len(want), batch4_loads=loads)
    broker, q, rec = _vector_e2e(torch, hist_json, "USER_PAGES", url_idx, uid, ts, "14h")
    got = {k: v["PAGES"] for k, v in last_values(broker, "USER_PAGES").items()}
    want: dict = {}
    for u, x, t in zip(url_idx.tolist(), uid.tolist(), ts.tolist()):
        m = want.setdefault((x, t - t % HOUR_MS), {})
        m[f"/page/{u}"] = m.get(f"/page/{u}", 0) + 1
    require(got == want, f"14h: the last maps differ from the URL counts ({len(got)} vs {len(want)} keys)")
    widest = max(len(m) for m in want.values())
    print(f"[14h] pv_user_pages: {n} events, {len(want)} (USER_ID, hour) keys, up to {widest} URLs a "
          f"map, {rec['sink_records']} sink records; {rec['events_per_s']:.1f} events/s; batch p50 "
          f"{rec['p50_ms']:.3f} ms p99 {rec['p99_ms']:.3f} ms; peak device memory {rec['peak_bytes']} B; "
          f"store {q.store_capacity} slots after {q.grows} grows (host rebuild s "
          f"{[round(x, 4) for x in q.rebuild_seconds]}); sink equals the CPU run ({rec['cpu_s']:.3f} s), "
          "maps equal the URL counts, overflow 0")
    out["user_pages"] = dict(rec, keys=len(want), widest_map=widest)
    return out


def _vector_head(torch, vec_json, seed, n_batches=VEC_BREAKDOWN_BATCHES):
    """Phase 14b's drive: phase 14's first ``n_batches`` batches."""
    url_idx, uid, ts = vector_traffic(seed)
    k = n_batches * VEC_ROWS
    return lambda: run_main_path(torch, vec_json, url_idx[:k], ts[:k], DEVICE, STORE, rows=VEC_ROWS,
                                 user_ids=uid[:k])[2]

# ----------------------------------------------- phases 2t, 15-17 (B19)
TA_USERS = 100_000  # BASELINE #3's USERS table (bench.py:556)
TA_REGIONS = 50  # bench.py:563: user k's region is k % 50
TA_ROWS = 1 << 16  # phases 15 and 17: 65,536-change batches (bench.py CAPACITY)
TA_UPDATE_BATCHES = 2  # phase 15: the update batches after the load (cut from 4)
SPENDERS_UPDATE_BATCHES = 2  # phase 17's (cut from 4 for the script's time)
TA_STORE = 1 << 19  # phase 15's store: the load check wants 4 batches of headroom below 0.75
ORDERS_ROWS = 4096  # phase 16's batch (phase_customer_orders says why)
ORDERS_BATCHES = 8  # cut from 32 and 16 for the script's time (still 2 grows)
ORDER_CUSTOMERS = 10_000
ORDERS_TWICE = 0.02  # phase 16: the share of changes that change an order again in its batch
ORDERS_STORE = 1 << 17  # asked for; the state budget clamps it to 8,192 slots
FIND_ROWS = 1 << 16  # phase 2t's K8 find mode: 65,536 rows
FIND_STORE = 1 << 17  # over 2^17 slots
UNDO_ROWS = ORDERS_ROWS  # phase 2t's K23: phase 16's batch
UNDO_STORE = 1 << 15  # into phase 16's store at the size it grows to
USERS_PLAN = os.path.join(_PLANS, "users_by_region.json")
ORDERS_PLAN = os.path.join(_PLANS, "customer_orders.json")
SPENDERS_PLAN = os.path.join(_PLANS, "big_spenders.json")
STATUSES = ("NEW", "SHIPPED", "DELIVERED")
TA_BREAKDOWN_BATCHES = 2  # phase 15b: the first update batches of phase 15


def make_find_case(torch, hs, rng, dev, n=FIND_ROWS, capacity=FIND_STORE):
    """Phase 2t's K8 find-mode case: a store 70% full of group keys (window
    0), 5% of them graves, and ``n`` rows whose group hashes are half
    stored keys (some of them graves now), half absent; 1% inactive.
    Returns the store (tensors), the rows' khash, base and active, and the
    store as numpy."""
    st = {k: v.numpy().copy() for k, v in hs.init_store(hs.StoreLayout(capacity, 1, ()), "cpu").items()}
    keys = rng.integers(-(2 ** 62), 2 ** 62, int(capacity * 0.7))
    slots = fill_store(hs, st["occ"], st["khash"], st["wstart"], capacity, keys,
                       np.zeros(keys.size, np.int64))
    graves = slots[rng.random(keys.size) < 0.05]
    st["occ"][graves] = False
    st["grave"][graves] = True
    khash = np.where(rng.random(n) < 0.5, rng.choice(keys, n), rng.integers(-(2 ** 62), 2 ** 62, n))
    store = {k: torch.from_numpy(v).to(dev) for k, v in st.items()}
    kh = torch.from_numpy(khash.astype(np.int64)).to(dev)
    base = hs.slot_base(kh, torch.zeros_like(kh), capacity)
    active = torch.from_numpy(rng.random(n) > 0.01).to(dev)
    return store, kh, base, active, st


def find_walk(hs, st, capacity, khash, active):
    """K8 find mode's walk replayed in numpy: the slots it reads (the
    data-dependent part of its bound)."""
    mask = capacity - 1
    cand = hs.np_mix64(khash) & mask
    todo = np.nonzero(active)[0]
    reads = 0
    for _ in range(32):
        if not todo.size:
            break
        c = cand[todo]
        reads += c.size
        done = (st["occ"][c] & (st["khash"][c] == khash[todo])) | ~(st["occ"][c] | st["grave"][c])
        todo = todo[~done]
        cand[todo] = (cand[todo] + 1) & mask
    return reads


def make_orders_case(torch, rng, dev, n=UNDO_ROWS, capacity=UNDO_STORE):
    """Phase 2t's customer_orders case: a ``capacity``-slot store, half of
    it holding groups — COUNT, SUM, COLLECT_LIST(ID) lists below, at and
    past their cap of 1,000 (with repeated ids), HISTOGRAM(STATUS) maps —
    and a populated dump row; an undo batch of ``n`` rows, the undo side's
    contributions (negated, or COLLECT_LIST's and HISTOGRAM's undo heads)
    of old rows whose ids and statuses the slots mostly hold (some twice in
    the batch, some not at all), 2% missed (the dump slot), 1% inactive.
    Returns the query, layout, store, slots and contributions."""
    from ksql_tpu_torch.common import types as T
    from ksql_tpu_torch.common.batch import stable_hash64
    from ksql_tpu_torch.compiler.torch_expr import DCol

    q, layout, store = _vector_query(torch, ORDERS_PLAN, n, capacity, dev)
    c1 = capacity + 1
    K = layout.components[4].width
    filled = rng.choice(capacity, capacity // 2, replace=False)
    cnt = np.zeros(c1, np.int64)
    cnt[filled] = np.where(rng.random(filled.size) < 0.7, rng.integers(1, 60, filled.size),
                           rng.choice([500, 999, 1000, 1001, 2500], filled.size))
    cnt[capacity] = 7
    ids = rng.integers(0, 1 << 40, (c1, K))
    dup = rng.random(c1) < 0.1
    ids[dup, 3] = ids[dup, 0]
    ids[dup, 7] = ids[dup, 0]
    held = np.arange(K)[None, :] < np.minimum(cnt, K)[:, None]
    codes = np.array([stable_hash64(s) for s in STATUSES], np.int64)
    hcnt = np.zeros(c1, np.int64)
    hcnt[filled] = rng.integers(1, 4, filled.size)
    hcnt[capacity] = 2
    hdata = np.zeros((c1, K), np.int64)
    hdata[:, :3] = codes[np.argsort(rng.random((c1, 3)), axis=1)]
    hheld = np.arange(K)[None, :] < hcnt[:, None]
    sums = {1: np.where(cnt > 0, cnt, 0), 2: rng.integers(100, 100_000, c1) / 4.0}
    for j, v in sums.items():
        store[f"a{j}"].copy_(torch.from_numpy(v.astype(np.float64 if j == 2 else np.int64)))
    store["a3"].copy_(torch.from_numpy(cnt))
    store["a4"].copy_(torch.from_numpy(np.where(held, ids, 0)))
    store["a5"].copy_(torch.from_numpy(held.astype(np.int8)))
    store["a6"].copy_(torch.from_numpy(hcnt))
    store["a7"].copy_(torch.from_numpy(np.where(hheld, hdata, 0)))
    store["a8"].copy_(torch.from_numpy(hheld.astype(np.int8)))
    store["a9"].copy_(torch.from_numpy(np.where(hheld, rng.integers(1, 30, (c1, K)), 0)))
    # undo rows: a zipf-ish share of the slots, an id each slot holds (85%:
    # repeats in the batch claim successive occurrences) or an absent one
    slots = filled[(rng.zipf(1.3, n) % 100_003) * 2654435761 % filled.size].astype(np.int64)
    pos = (rng.random(n) * np.minimum(cnt[slots], K)).astype(np.int64)
    oid = np.where(rng.random(n) < 0.85, ids[slots, pos], rng.integers(0, 1 << 40, n))
    status = codes[rng.integers(0, 3, n)]
    slots[rng.random(n) < 0.02] = capacity
    active = torch.from_numpy(rng.random(n) > 0.01).to(dev)
    args = {
        "AMOUNT": DCol(torch.from_numpy(rng.integers(100, 100_000, n) / 4.0).to(dev),
                       torch.ones(n, dtype=torch.bool, device=dev), T.DOUBLE),
        "ID": DCol(torch.from_numpy(oid).to(dev), torch.ones(n, dtype=torch.bool, device=dev), T.BIGINT),
        "STATUS": DCol(torch.from_numpy(status).to(dev), torch.ones(n, dtype=torch.bool, device=dev),
                       T.STRING),
    }
    contribs = [torch.from_numpy(rng.integers(0, 1 << 40, n)).to(dev)]
    for spec in q.agg_specs:
        cols = [args[e.name] for e in spec.arg_exprs]
        if spec.device.undo_contribs is not None:
            contribs.extend(spec.device.undo_contribs(cols, active))
        else:
            contribs.extend(-x for x in spec.device.contribs(cols, active))
    return dict(q=q, layout=layout, store=store, slots=torch.from_numpy(slots.astype(np.int32)).to(dev),
                contribs=contribs, active=active)


def check_remove_doubles(torch, rng, dev, capacity=1 << 10, n=UNDO_ROWS, K=1000):
    """K23 over a COLLECT_LIST of DOUBLE with -0.0, +0.0, NaN: lists below,
    at and past the cap, undo values taken from the slots (±0.0 match each
    other, a NaN nothing), a populated dump row; exact (bits)."""
    from ksql_tpu_torch.ops import hash_store as hs
    from ksql_tpu_torch.ops import vector as vec

    layout = hs.StoreLayout(capacity, 1, (
        hs.AggComponent("max", "int64", 0), hs.AggComponent("vec_count", "int64", 0),
        hs.AggComponent("vec_data", "float64", 0, width=K, mode="append"),
        hs.AggComponent("vec_valid", "int8", 0, width=K)))
    pool = np.array([-0.0, 0.0, np.nan, 1.5, -2.0, 7.25, 1e300], np.float64)
    c1 = capacity + 1
    cnt = rng.choice([0, 3, 40, 999, 1000, 1001, 3000], c1).astype(np.int64)
    data = pool[rng.integers(0, pool.size, (c1, K))]
    vbit = (rng.random((c1, K)) < 0.9).astype(np.int8)
    slots = rng.integers(0, c1, n)
    vals = np.where(rng.random(n) < 0.8, data[slots, rng.integers(0, 40, n)], pool[rng.integers(0, 7, n)])
    store = {"a1": torch.from_numpy(cnt).to(dev), "a2": torch.from_numpy(data).to(dev),
             "a3": torch.from_numpy(vbit).to(dev)}
    contribs = [None, torch.from_numpy(-(rng.random(n) < 0.95).astype(np.int64)).to(dev),
                torch.from_numpy(vals).to(dev), torch.ones(n, dtype=torch.int8, device=dev)]
    sl = torch.from_numpy(slots.astype(np.int32)).to(dev)
    got = {k: v.clone() for k, v in store.items()}
    vec.vec_remove(got, layout, 1, contribs, sl)
    vec.vec_remove_plain(store, layout, 1, contribs, sl)
    torch.cuda.synchronize()
    _assert_store(torch, "vec_remove[DOUBLE]", got, store, list(store))
    print("[2t] vec_remove over DOUBLE (-0.0, +0.0, NaN; lists below, at and past 1,000): exact (bits)")


def check_vec_remove(torch, layout, ostore, slots, contribs, dev, j=3):
    """K23 on the collect group at component ``j`` of a ``make_orders_case``
    store: the kernel against its twin (bits; count, data and null bits),
    then timed from the same store every launch.  K23's bound from this
    case's counts: per removing slot its count and its first min(count, K)
    cells (8-byte id + null bit) each way, and the dump row's rewrite
    (min(count, K) cells read, all K written) when some row of the batch is
    not its slot's lowest undo row.  Returns the record and what the case
    holds."""
    from ksql_tpu_torch.ops import vector as vec

    n, cap = slots.shape[0], layout.capacity
    keys = [f"a{j + t}" for t in range(3)]
    K = layout.components[j + 1].width
    s_np = slots.cpu().numpy()
    touched = np.unique(s_np[s_np != cap])
    removing = (contribs[j].cpu().numpy() < 0) & (s_np != cap)
    held = np.minimum(ostore[keys[0]].cpu().numpy(), K)
    rslots = np.unique(s_np[removing])
    remove_bytes = n * (8 + 8 + 1 + 4) + rslots.size * 16 + 2 * 9 * int(held[rslots].sum())
    if rslots.size < n:
        remove_bytes += 8 + 9 * (int(held[cap]) + K)
    saved = {k: ostore[k].clone() for k in keys}
    work = {k: ostore[k].clone() for k in keys}
    twin = {k: ostore[k].clone() for k in keys}
    vec.vec_remove(work, layout, j, contribs, slots)
    vec.vec_remove_plain(twin, layout, j, contribs, slots)
    torch.cuda.synchronize()
    _assert_store(torch, "vec_remove", work, twin, keys)
    removed = int((saved[keys[0]] - twin[keys[0]]).sum())
    capped = int((saved[keys[0]][torch.from_numpy(touched).to(dev)] >= K).sum())
    rows_capped = int(np.isin(s_np[removing], touched[saved[keys[0]].cpu().numpy()[touched] >= K]).sum())
    require(removed > 0, f"vec_remove: {removed} entries removed")
    rec = measure(
        torch, "vec_remove", lambda: vec.vec_remove(work, layout, j, contribs, slots),
        lambda: vec.vec_remove_plain(work, layout, j, contribs, slots), remove_bytes, n * 40,
        reset=lambda: [work[k].copy_(saved[k]) for k in keys], plain_reps=10)
    what = (f"COLLECT_LIST(ID), K = {K}: {n} undo rows into {touched.size} slots ({capped} at or past "
            f"the cap; {rslots.size} with a removing row, {int(held[rslots].sum())} cells held; "
            f"{int(removing.sum())} removing rows, {rows_capped} of them on capped slots), "
            f"{removed} entries removed")
    return dict(rec, removed=removed, capped=capped), what


def phase_table_agg_kernels(torch, seed):
    """Phase 2t: K8's find mode, K23 vec_remove, K20 hist + K22 with the
    undo side's negative heads and K3 on negated contributions, against
    their twins at the slice's shapes.  Returns ``({kernel: {mode:
    record}}, extra records)``."""
    from ksql_tpu_torch.ops import hash_store as hs
    from ksql_tpu_torch.ops import vector as vec

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(seed + 40)
    recs: dict = {}
    extra: dict = {}

    def done(kernel, mode, rec, what, into=None):
        rec = dict(rec, max_abs_err=rec.get("max_abs_err", 0.0))
        if into is None:
            recs.setdefault(kernel, {})[mode] = rec
        else:
            extra[into] = rec
        if rec["library_ms"] is None:
            what += "; no single PyTorch call computes it"
        _report("2t", f"{kernel}[{mode}] ({what})", rec)

    # ---- K8 find mode
    store, kh, base, active, st = make_find_case(torch, hs, rng, dev)
    n, cap = kh.shape[0], store["occ"].shape[0] - 1
    got = hs.probe_find_slots(store, cap, kh, base, active)
    want = hs.probe_find_plain(store, cap, kh, torch.zeros_like(kh), active)
    _assert_equal(torch, "probe_find[find]", got, want)
    found = int((want != cap).sum())
    require(0.3 * n < found < 0.7 * n, f"probe_find[find]: {found} of {n} rows found, about half expected")
    reads = find_walk(hs, st, cap, kh.cpu().numpy(), active.cpu().numpy())
    done("probe_find", "find", measure(
        torch, "probe_find", lambda: hs.probe_find_slots(store, cap, kh, base, active),
        lambda: hs.probe_find_plain(store, cap, kh, torch.zeros_like(kh), active),
        n * (8 + 4 + 1) + n * 4 + reads * 18, reads * 6, plain_reps=10),
        f"{n} rows over {cap} slots 70% full, {found} found, {reads} slot reads")
    del store, st

    # ---- K23, K20 hist and K22 on the undo side of phase 16's store
    c = make_orders_case(torch, rng, dev)
    layout, ostore, slots, contribs = c["layout"], c["store"], c["slots"], c["contribs"]
    n, cap = slots.shape[0], layout.capacity
    s_np = slots.cpu().numpy()
    touched = np.unique(s_np[s_np != cap])
    rec, what = check_vec_remove(torch, layout, ostore, slots, contribs, dev)
    rec.pop("removed")
    require(rec.pop("capped") > 0, "vec_remove: no slot at the cap")
    done("vec_remove", "remove", rec, what)
    check_remove_doubles(torch, rng, dev)
    hkeys = [f"a{j}" for j in (6, 7, 8, 9)]
    hsaved = {k: ostore[k].clone() for k in hkeys}
    work = {k: ostore[k].clone() for k in hkeys}
    twin = {k: ostore[k].clone() for k in hkeys}
    require(bool((contribs[6] <= 0).all()) and bool((contribs[6] < 0).any()),
            "hist undo: the heads must be negative")
    vec.vec_collect(work, layout, 6, contribs, slots, "hist")
    vec.vec_collect_plain(twin, layout, 6, contribs, slots, "hist")
    _assert_store(torch, "vec_collect[hist, undo]", work, twin, hkeys)
    after1 = {k: work[k].clone() for k in hkeys}
    vec.vec_hist(work, layout, 6, contribs, slots)
    vec.vec_hist_plain(twin, layout, 6, contribs, slots)
    _assert_store(torch, "vec_hist[undo]", work, twin, hkeys)
    bumped = _changed_cells(torch, after1, twin, hkeys[3:])
    done("vec_collect", "hist", measure(
        torch, "vec_collect", lambda: vec.vec_collect(work, layout, 6, contribs, slots, "hist"),
        lambda: vec.vec_collect_plain(work, layout, 6, contribs, slots, "hist"),
        n * 21 + touched.size * (16 + 3 * 9), n * 40,
        reset=lambda: [work[k].copy_(hsaved[k]) for k in hkeys], plain_reps=10),
        f"HISTOGRAM(STATUS) undo: {n} rows with heads <= 0 into {touched.size} slots, nothing appended",
        into="vec_collect_hist_undo")
    done("vec_hist", "hist", measure(
        torch, "vec_hist", lambda: vec.vec_hist(work, layout, 6, contribs, slots),
        lambda: vec.vec_hist_plain(work, layout, 6, contribs, slots),
        n * 21 + touched.size * (8 + 3 * 9) + bumped * 16, n * 40,
        reset=lambda: [work[k].copy_(after1[k]) for k in hkeys], plain_reps=10),
        f"HISTOGRAM(STATUS) undo: {n} negative heads into {bumped} entries", into="vec_hist_undo")
    del c, ostore, work, twin, hsaved, after1

    # ---- K3 on the undo side of phase 15: 65,536 negated rows into 50 regions
    base_st, scratch, ulayout, slots, contribs, active = make_undo_fold_case(torch, hs, rng, dev)
    n = TA_ROWS
    keys = list(base_st)
    kst, pst = _clone(base_st), _clone(base_st)
    w_k = hs.fold_and_mark(kst, scratch, ulayout, slots, contribs, active)
    w_p = hs.fold_and_mark_plain(pst, ulayout, slots, contribs, active)
    _assert_equal(torch, "fold_and_mark[undo].winners", w_k, w_p)
    err = 0.0
    for k in keys:
        err = max(err, _assert_equal(torch, f"fold_and_mark[undo].{k}", kst[k], pst[k], rtol=1e-12))
    n_comp = len(ulayout.components)
    rec = measure(torch, "fold_and_mark", lambda: hs.fold_and_mark(kst, scratch, ulayout, slots, contribs, active),
                  lambda: hs.fold_and_mark_plain(kst, ulayout, slots, contribs, active),
                  n * (4 + 1 + 1 + 8 * n_comp) + TA_REGIONS * (8 * n_comp + 1), n * n_comp,
                  reset=lambda: _restore(kst, base_st),
                  library=lambda: [kst[f"a{j}"].index_add_(0, slots.long(), contribs[j].to(kst[f"a{j}"].dtype))
                                   for j in range(1, n_comp)])
    rec["max_abs_err"] = err
    done("fold_and_mark", "undo", rec,
         f"{n} negated rows into {TA_REGIONS} region slots (1% missed: the dump slot), {n_comp} components; "
         "yardstick index_add_ per component", into="fold_and_mark_undo")
    return recs, extra


def make_undo_fold_case(torch, hs, rng, dev):
    """K3's case on the undo side of phase 15: TA_ROWS negated rows of
    users_by_region into TA_REGIONS region slots of a TA_STORE-slot store
    (1% of them at the dump slot, 0.1% inactive), its 8 components.
    Returns (store columns and ``dirty``, scratch, layout, slots,
    contribs, active)."""
    from ksql_tpu_torch.common import types as T
    from ksql_tpu_torch.compiler.torch_expr import DCol

    q, ulayout, ustore = _vector_query(torch, USERS_PLAN, TA_ROWS, TA_STORE, dev)
    n = TA_ROWS
    region_slots = rng.choice(TA_STORE, TA_REGIONS, replace=False)
    for j, comp in enumerate(ulayout.components):
        if comp.combine == "add":
            v = rng.integers(2000, 3000, TA_STORE + 1)
            ustore[f"a{j}"].copy_(torch.from_numpy(v.astype(np.float64 if comp.dtype == "float64"
                                                            else comp.dtype)))
    slots = region_slots[rng.integers(0, TA_REGIONS, n)].astype(np.int32)
    slots[rng.random(n) < 0.01] = TA_STORE  # old rows whose group is gone
    slots = torch.from_numpy(slots).to(dev)
    active = torch.from_numpy(rng.random(n) > 0.001).to(dev)
    amt = DCol(torch.from_numpy(rng.integers(0, 1001, n).astype(np.int32)).to(dev),
               torch.ones(n, dtype=torch.bool, device=dev), T.INTEGER)
    ts = torch.from_numpy(TS0 + np.arange(n, dtype=np.int64) * 17).to(dev)
    contribs = [torch.where(active, ts, torch.full_like(ts, np.iinfo(np.int64).min))]  # never negated
    for spec in q.agg_specs:
        contribs.extend(-x for x in spec.device.contribs([amt] * len(spec.arg_exprs), active))
    keys = [f"a{j}" for j in range(len(ulayout.components))] + ["dirty"]
    return ({k: ustore[k].clone() for k in keys}, hs.init_scratch(TA_STORE, dev), ulayout, slots,
            contribs, active)


# -------------------------------------------------------- phase 15/17 data
def users_traffic(seed, n_updates=TA_UPDATE_BATCHES * TA_ROWS):
    """Phases 15 and 17's changelog of USERS (ID INT PRIMARY KEY, REGION,
    AMT): the 100,000 users inserted (region ``k % 50``, AMT uniform
    0..1,000), then ``n_updates`` changes of uniformly drawn users: 70% a
    new AMT in the same region, 20% a move to another region with a new
    AMT, 10% a delete; a change to a deleted user re-inserts it.  Returns
    ``(records, final)``: records ``(key, value dict or None)`` in order,
    and the final table ``(region, amt, live)`` as numpy."""
    rng = np.random.default_rng(seed + 30)
    region = np.arange(TA_USERS) % TA_REGIONS
    amt = rng.integers(0, 1001, TA_USERS)
    live = np.ones(TA_USERS, bool)
    recs = [(k, {"REGION": f"r{region[k]}", "AMT": int(amt[k])}) for k in range(TA_USERS)]
    ids = rng.integers(0, TA_USERS, n_updates)
    op = rng.random(n_updates)
    new_amt = rng.integers(0, 1001, n_updates)
    new_reg = rng.integers(1, TA_REGIONS, n_updates)
    for i in range(n_updates):
        k = int(ids[i])
        if live[k] and op[i] >= 0.9:
            live[k] = False
            recs.append((k, None))
            continue
        if not live[k] or op[i] >= 0.7:  # a re-insert or a move: another region
            region[k] = (region[k] + new_reg[i]) % TA_REGIONS
        live[k] = True
        amt[k] = new_amt[i]
        recs.append((k, {"REGION": f"r{region[k]}", "AMT": int(amt[k])}))
    return recs, (region, amt, live)


def produce_changes(broker, topic, recs, first=0):
    """The changelog records of ``recs`` ((key, value dict or None)) on
    ``topic``, 17 ms apart from change number ``first`` on, a tombstone for
    None."""
    from ksql_tpu_torch.runtime.topics import Record

    t = broker.create_topic(topic)
    for i, (k, v) in enumerate(recs, start=first):
        value = None if v is None else json.dumps(v, separators=(",", ":"))
        t.produce(Record(key=k, value=value, timestamp=TS0 + 17 * i, partition=0))


def run_table_path(torch, plan_json, topic, recs, device, rows, store, batch_seconds=None, path=None,
                   load=0):
    """The runner over a table source's changelog: ``start_plan``, then
    the first ``load`` changes run to the end and drained, then the rest
    (so no batch holds both), as ``run_plan`` does in one go when ``load``
    is 0.  With ``batch_seconds`` each change batch is timed to a
    ``torch.cuda.synchronize()``; with a ``path`` the launch counts are set
    to 0 just before and read just after, and held to
    ``PATH_KERNELS[path]``.  Returns the broker, the executor, the seconds
    and the number of batches the load ran in."""
    from ksql_tpu_torch.runner import run_until_quiescent, start_plan
    from ksql_tpu_torch.runtime.device_executor import TorchDeviceExecutor
    from ksql_tpu_torch.runtime.topics import Broker

    broker = Broker()
    produce_changes(broker, topic, recs[:load] if load else recs)
    load_batches = 0
    run_changes = TorchDeviceExecutor._run_change_batch
    if batch_seconds is not None:
        def timed(self):
            t0 = time.perf_counter()
            out = run_changes(self)
            torch.cuda.synchronize()
            batch_seconds.append(time.perf_counter() - t0)
            return out
        TorchDeviceExecutor._run_change_batch = timed
    try:
        if path is not None:
            zero_launches()
        t0 = time.perf_counter()
        h = start_plan(plan_json, broker, device=device, capacity=rows, store_capacity=store)
        if load:
            run_until_quiescent(h)
            h.executor.drain()
            load_batches = len(batch_seconds or ())
            produce_changes(broker, topic, recs[load:], first=load)
        run_until_quiescent(h)
        h.executor.drain()
        if device != "cpu":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        TorchDeviceExecutor._run_change_batch = run_changes
    if path is not None:
        PATH_LAUNCHES[path] = read_launches()
        check_path_launches(path, PATH_LAUNCHES[path])
    return broker, h.executor, secs, load_batches


def _table_e2e(torch, plan_json, topic, sink, recs, rows, store, tag, load=0):
    """A table-source plan on the card (launches held to ``PATH_KERNELS
    [tag]``) and on the CPU; the sinks must be equal record for record.
    With a ``load`` (see :func:`run_table_path`) the batch p50/p99 are
    those of the batches after it."""
    torch.cuda.reset_peak_memory_stats()
    batch_s = []
    broker, ex, secs, n_load = run_table_path(torch, plan_json, topic, recs, DEVICE, rows, store,
                                              batch_s, path=tag, load=load)
    peak = torch.cuda.max_memory_allocated()
    q = ex.query
    if q.table_agg:
        require(int(q.state["overflow"]) == 0, f"{tag}: store overflowed")
    cpu_broker, _ex, cpu_secs, _n = run_table_path(torch, plan_json, topic, recs, "cpu", rows, store,
                                                   load=load)
    got = sink_records(broker, sink)
    require(got == sink_records(cpu_broker, sink), f"{tag}: card sink differs from the CPU run")
    p50, p99 = np.percentile(np.array(batch_s[n_load:]) * 1e3, [50, 99])
    rec = dict(events_per_s=len(recs) / secs, p50_ms=p50, p99_ms=p99, peak_bytes=peak,
               batches=len(batch_s), load_batches=n_load, sink_records=len(got), cpu_s=cpu_secs,
               grows=q.grows, store_slots=q.store_capacity, rebuild_s=list(q.rebuild_seconds))
    return broker, q, rec


def phase_users_by_region(torch, plan_json, seed):
    """Phase 15: users_by_region.json (COUNT, SUM, AVG, STDDEV_SAMPLE of
    AMT per REGION over the USERS table) through ``run_plan`` over
    :func:`users_traffic` in 65,536-change batches: the sink must equal the
    CPU run record for record, the last C/S/A/SD per region the numpy
    aggregates of the final table (C and S exact, A and SD to rtol 1e-12:
    the sums of integer AMT are exact in float64 in any order), no
    overflow."""
    recs, (region, amt, live) = users_traffic(seed)
    broker, q, rec = _table_e2e(torch, plan_json, "u", "USERS_BY_REGION", recs, TA_ROWS, TA_STORE, "15",
                                load=TA_USERS)
    got = {json.loads(k) if k.startswith('"') else k: json.loads(v)
           for k, v, _t, _w in sink_records(broker, "USERS_BY_REGION") if v is not None}
    for r in range(TA_REGIONS):
        a = amt[live & (region == r)].astype(np.float64)
        n = a.size
        s, ss = a.sum(), (a * a).sum()
        sd = np.sqrt(max((ss - s * s / n) / (n - 1), 0.0))
        g = got.get(f"r{r}")
        require(g is not None and g["C"] == n and g["S"] == int(s),
                f"15: region r{r}: {g} vs C {n} S {int(s)}")
        require(np.isclose(g["A"], s / n, rtol=1e-12, atol=0) and np.isclose(g["SD"], sd, rtol=1e-12, atol=0),
                f"15: region r{r}: A {g['A']} SD {g['SD']} vs {s / n} {sd}")
    print(f"[15] users_by_region: {len(recs)} changes ({TA_USERS} inserts in {rec['load_batches']} "
          f"batches, then {len(recs) - TA_USERS} updates, moves, deletes and re-inserts in "
          f"{rec['batches'] - rec['load_batches']} batches of {TA_ROWS}); {rec['sink_records']} sink "
          f"records; {rec['events_per_s']:.1f} events/s; update batch p50 {rec['p50_ms']:.3f} ms p99 "
          f"{rec['p99_ms']:.3f} ms; peak device memory {rec['peak_bytes']} B; "
          f"sink equals the CPU run ({rec['cpu_s']:.3f} s), C/S/A/SD per region equal numpy over the final "
          "table, overflow 0")
    return rec


def phase_big_spenders(torch, plan_json, seed):
    """Phase 17: big_spenders.json (ID, REGION, AMT of the USERS with AMT >
    500) over phase 15's changelog: the sink must equal the CPU run, and
    the per-change rule: a change whose new row passes emits it, one whose
    old row passed while its new row fails or is a delete emits a
    tombstone, any other emits nothing; the last value per key is then the
    final table's filter."""
    recs, (region, amt, live) = users_traffic(seed, SPENDERS_UPDATE_BATCHES * TA_ROWS)
    broker, q, rec = _table_e2e(torch, plan_json, "u", "BIG_SPENDERS", recs, TA_ROWS, TA_STORE, "17",
                                load=TA_USERS)
    require(q.table_mode, "17: not a table transform")
    want, table = [], {}
    for k, v in recs:
        old = table.get(k)
        if v is None:
            table.pop(k, None)
        else:
            table[k] = v
        if v is not None and v["AMT"] > 500:
            want.append((k, {"REGION": v["REGION"], "AMT": v["AMT"]}))
        elif old is not None and old["AMT"] > 500:
            want.append((k, None))
    got = [(int(k), None if v is None else json.loads(v))
           for k, v, _t, _w in sink_records(broker, "BIG_SPENDERS")]
    require(got == want, f"17: the sink differs from the per-change rule ({len(got)} vs {len(want)} records)")
    last = {}
    for k, v in got:
        last[k] = v
    final = {k: {"REGION": f"r{region[k]}", "AMT": int(amt[k])}
             for k in np.nonzero(live & (amt > 500))[0].tolist()}
    require({k: v for k, v in last.items() if v is not None} == final,
            "17: the last values differ from AMT > 500 over the final table")
    tombs = sum(v is None for _k, v in got)
    print(f"[17] big_spenders: {len(recs)} changes, {rec['sink_records']} sink records ({tombs} tombstones); "
          f"{rec['events_per_s']:.1f} events/s; update batch p50 {rec['p50_ms']:.3f} ms p99 "
          f"{rec['p99_ms']:.3f} ms over {rec['batches'] - rec['load_batches']} batches; "
          f"peak device memory {rec['peak_bytes']} B; sink equals the CPU run ({rec['cpu_s']:.3f} s) and the "
          "per-change rule, final rows equal AMT > 500 over the final table")
    return dict(rec, tombstones=tombs)


# ------------------------------------------------------- phase 16 data
def orders_traffic(seed, n_batches=ORDERS_BATCHES, rows=ORDERS_ROWS, twice=ORDERS_TWICE):
    """Phase 16's changelog of ORDERS (ID, CUSTOMER_ID, STATUS, AMOUNT), in
    batches of ``rows``: 40% new orders (NEW) of zipf(1.3) customers,
    amounts in quarters (so float sums are exact in any order); 50% a
    status move of a live order (NEW -> SHIPPED, or CANCELLED one time in
    ten; SHIPPED -> DELIVERED; a DELIVERED or CANCELLED order is deleted);
    10% a delete.  A change is mostly of an order the batch has not changed
    yet; a ``twice`` share of them changes again an order the batch has
    already changed (one that lived before the batch), where the
    reference's batch rule (undo every old row, then apply every new one)
    can leave its customer's list and map apart from the final table (ROADMAP
    C6).  Returns the batches of ``(key, old, new)`` and the customers of
    the orders changed twice in a batch."""
    rng = np.random.default_rng(seed + 31)
    orders: dict = {}
    ids: list = []
    where: dict = {}
    next_id = 0
    out = []
    again: set = set()

    def drop(k):
        i = where.pop(k)
        last = ids.pop()
        if last != k:
            ids[i] = last
            where[last] = i
        return orders.pop(k)

    for _ in range(n_batches):
        batch, touched, moved = [], set(), []
        for _ in range(rows):
            r = rng.random()
            k = None
            if r >= 0.4 and moved and rng.random() < twice:
                cand = moved[int(rng.integers(0, len(moved)))]
                if cand in orders:  # not deleted earlier in the batch
                    k = cand
                    again.add(orders[k]["CUSTOMER_ID"])
            if k is None and r >= 0.4 and ids:
                for _try in range(4):
                    cand = ids[int(rng.integers(0, len(ids)))]
                    if cand not in touched:
                        k = cand
                        break
            if k is None:
                k, next_id = next_id, next_id + 1
                new = {"CUSTOMER_ID": int(rng.zipf(1.3)) % ORDER_CUSTOMERS, "STATUS": "NEW",
                       "AMOUNT": int(rng.integers(100, 100_000)) / 4}
                orders[k] = new
                where[k] = len(ids)
                ids.append(k)
                batch.append((k, None, new))
            else:
                old = orders[k]
                st = old["STATUS"]
                if r >= 0.9 or st in ("DELIVERED", "CANCELLED"):
                    batch.append((k, drop(k), None))
                else:
                    if st == "SHIPPED":
                        nxt = "DELIVERED"
                    else:  # NEW
                        nxt = "CANCELLED" if rng.random() < 0.1 else "SHIPPED"
                    new = dict(old, STATUS=nxt)
                    orders[k] = new
                    batch.append((k, old, new))
                moved.append(k)
            touched.add(k)
        out.append(batch)
    return out, again


def orders_model(batches, K=1000):
    """customer_orders by the reference's batch rule, in Python: per batch
    every old row that passed the WHERE is undone at its customer if the
    customer has a group — N and TOTAL drop; its id, the r-th of the batch
    for that id, leaves its customer's list (entries past min(count, 1,000)
    are not looked at; the count, which runs past 1,000, drops by the
    entries removed); its status's count drops where the map holds it —
    then every passing new row is applied: N and TOTAL rise, its id is
    appended where the count is below 1,000 (the count rises anyway), its
    status joins the map where new and its count rises.  Returns per
    customer (N, TOTAL, ORDER_IDS as emitted, BY_STATUS as emitted, the
    largest list count seen)."""
    groups: dict = {}

    def passes(row):
        return row is not None and row["STATUS"] != "CANCELLED"

    for batch in batches:
        undo: dict = {}
        for k, old, _new in batch:
            if passes(old) and old["CUSTOMER_ID"] in groups:
                undo.setdefault(old["CUSTOMER_ID"], []).append((k, old))
        for cust, rows in undo.items():
            g = groups[cust]
            cells = g["cells"][: min(g["c"], K)]
            seen: dict = {}
            gone = set()
            for k, old in rows:
                g["n"] -= 1
                g["total"] -= old["AMOUNT"]
                r = seen.get(k, 0)
                seen[k] = r + 1
                hits = [p for p, v in enumerate(cells) if v == k]
                if r < len(hits):
                    gone.add(hits[r])
                st = old["STATUS"]
                if st in g["hist"]:
                    g["hist"][st] -= 1
            kept = [v for p, v in enumerate(cells) if p not in gone]
            g["cells"] = kept
            g["c"] -= len(gone)
        for k, _old, new in batch:
            if not passes(new):
                continue
            g = groups.setdefault(new["CUSTOMER_ID"], {"n": 0, "total": 0.0, "cells": [], "c": 0,
                                                       "hist": {}, "max_c": 0})
            g["n"] += 1
            g["total"] += new["AMOUNT"]
            if g["c"] < K:
                # a list compacted past the cap keeps zero (null) cells
                g["cells"] += [None] * (g["c"] - len(g["cells"])) + [k]
            g["c"] += 1
            g["max_c"] = max(g["max_c"], g["c"])
            g["hist"][new["STATUS"]] = g["hist"].get(new["STATUS"], 0) + 1
    out = {}
    for cust, g in groups.items():
        m = min(g["c"], K)
        ids = (g["cells"] + [None] * m)[:m]
        out[cust] = (g["n"], g["total"], ids, {s: c for s, c in g["hist"].items() if c > 0}, g["max_c"])
    return out


def phase_customer_orders(torch, plan_json, seed):
    """Phase 16: customer_orders.json (COUNT, SUM(AMOUNT), COLLECT_LIST(ID)
    and HISTOGRAM(STATUS) of the orders that are not CANCELLED, per
    CUSTOMER_ID) through ``run_plan`` over :func:`orders_traffic` in
    batches of 4,096: the state budget clamps this ~26 KB-a-slot store to
    8,192 slots, and a table aggregation checks its load after every batch
    with four batches of headroom, so it grows at once; a 4,096-change
    batch of new customers stays below 0.5 load before that check (ROADMAP
    C1: K2 loses rows from about 0.47).  The sink must equal the CPU run
    record for record; the last value per customer must equal
    :func:`orders_model`, and N and TOTAL the final table's; BY_STATUS,
    and ORDER_IDS as a multiset where the list never passed its cap, too,
    for the customers with no order changed twice in a batch (the batch
    rule's phantom, ROADMAP C6); the store must grow and not overflow."""
    batches, again = orders_traffic(seed)
    twice = sum(len(b) - len({k for k, _o, _n in b}) for b in batches)
    require(twice > 0, "16: no order changed twice in a batch")
    recs = []
    for batch in batches:
        recs += [(k, None if new is None else dict(new)) for k, _old, new in batch]
    # the clamped store's load once batch 1 has inserted (its first load check)
    load = len({new["CUSTOMER_ID"] for _k, _old, new in batches[0] if new is not None}) / 8192
    broker, q, rec = _table_e2e(torch, plan_json, "orders", "CUSTOMER_ORDERS", recs, ORDERS_ROWS,
                                ORDERS_STORE, "16")
    require(q.grows >= 1, f"16: the store did not grow ({q.store_capacity} slots)")
    got = {int(k): json.loads(v) for k, v, _t, _w in sink_records(broker, "CUSTOMER_ORDERS")
           if v is not None}
    model = orders_model(batches)
    require(set(got) == set(model), f"16: {len(got)} customers in the sink, {len(model)} in the model")
    final: dict = {}
    table: dict = {}
    for k, v in recs:
        if v is None:
            table.pop(k, None)
        else:
            table[k] = v
    for k, v in table.items():
        if v["STATUS"] != "CANCELLED":
            f = final.setdefault(v["CUSTOMER_ID"], [0, 0.0, [], {}])
            f[0] += 1
            f[1] += v["AMOUNT"]
            f[2].append(k)
            f[3][v["STATUS"]] = f[3].get(v["STATUS"], 0) + 1
    capped = phantoms = 0
    for cust, (n, total, ids, hist, max_c) in model.items():
        g = got[cust]
        require((g["N"], g["TOTAL"], g["ORDER_IDS"], g["BY_STATUS"]) == (n, total, ids, hist),
                f"16: customer {cust}: sink {g['N']}, {g['TOTAL']}, {len(g['ORDER_IDS'])} ids vs the "
                f"model's {n}, {total}, {len(ids)}")
        fn, ftotal, fids, fhist = final.get(cust, [0, 0.0, [], {}])
        require((n, total) == (fn, ftotal), f"16: customer {cust}: N/TOTAL differ from the final table")
        capped += max_c > 1000
        if cust in again:
            phantoms += (hist, sorted(ids, key=str)) != (fhist, sorted(fids, key=str))
            continue
        require(hist == fhist, f"16: customer {cust}: BY_STATUS differs from the final table")
        if max_c <= 1000:
            require(sorted(ids) == sorted(fids), f"16: customer {cust}: ORDER_IDS differ from the table's")
    require(phantoms > 0, "16: no second change left the batch rule's phantom")
    widest = max(len(v[2]) for v in model.values())
    print(f"[16] load of the 8,192-slot store when batch 1 has inserted: {load:.3f}")
    print(f"[16] customer_orders: {len(recs)} changes in {rec['batches']} batches of {ORDERS_ROWS}, "
          f"{len(model)} customers ({capped} whose list passed the 1,000 cap), the longest list {widest}; "
          f"{twice} second changes of an order in its batch, at {len(again)} customers ({phantoms} of "
          "them keep the batch rule's phantom in their list or map); "
          f"{rec['sink_records']} sink records; {rec['events_per_s']:.1f} events/s; batch p50 "
          f"{rec['p50_ms']:.3f} ms p99 {rec['p99_ms']:.3f} ms; peak device memory {rec['peak_bytes']} B; "
          f"store {q.store_capacity} slots after {q.grows} grows (host rebuild s "
          f"{[round(x, 4) for x in q.rebuild_seconds]}); sink equals the CPU run ({rec['cpu_s']:.3f} s), "
          "the last values the batch-rule model, N/TOTAL the final table (and BY_STATUS, ORDER_IDS below "
          "the cap, where no order changed twice in a batch), overflow 0")
    return dict(rec, customers=len(model), capped=capped, batch1_load=load, twice=twice,
                twice_customers=len(again), phantoms=phantoms)


def _users_head(torch, plan_json, seed, n_batches=TA_BREAKDOWN_BATCHES):
    """Phase 15b's drive: phase 15's load, then its first ``n_batches``
    update batches timed as the breakdown's window."""
    from ksql_tpu_torch.runner import run_until_quiescent, start_plan
    from ksql_tpu_torch.runtime.topics import Broker

    recs, _final = users_traffic(seed, n_updates=n_batches * TA_ROWS)
    broker = Broker()
    h = start_plan(plan_json, broker, device=DEVICE, capacity=TA_ROWS, store_capacity=TA_STORE)
    produce_changes(broker, "u", recs[:TA_USERS])  # the load, run before the window
    run_until_quiescent(h)
    h.executor.drain()
    produce_changes(broker, "u", recs[TA_USERS:], first=TA_USERS)

    def drive():
        t0 = time.perf_counter()
        run_until_quiescent(h)
        h.executor.drain()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    return drive


# ------------------------------------------------ phases 2x, 18, 18g, 19
TT_USERS = 100_000  # BASELINE #3's USERS (bench.py:556)
TT_ACCOUNTS = 90_000  # ACCOUNTS holds 90% of the users: the LEFT join pads 10%
TT_ROWS = 1 << 16  # phase 18's batch (bench.py CAPACITY)
TT_STORE = 1 << 18  # bench.py:557's table store
TT_UPDATE_BATCHES = 2  # phase 18's update batches after the load (cut from 4)
TT_BREAKDOWN_BATCHES = 2  # phase 18b: two more update batches under the breakdown's timers
TT_GROW_TICK = 4096  # phase 18g: 4,096-change batches
TT_GROW_TICKS = 8
TT_GROW_STORE = 1 << 14
TIERS = ("bronze", "silver", "gold", "platinum")
FK_USERS = 2_500  # phase 19's customers (cut from 10,000 by the per-record rule, PERF.md §4)
FK_ORDERS = 4_096  # cut from 16,384 by the per-record rule (PERF.md §4); K24's full size is phase 2x's
FK_STEP_ORDERS = 16_384  # phase 2x's K2 case: the orders store of phase 19 before its cut
FK_USER_CHANGES = 512  # cut from 1,024 for the script's time
FK_ORDER_CHANGES = 512  # cut from 1,024 for the script's time
FK_STORE = 1 << 16  # the load stays <= 0.5 (ROADMAP C1)
FAN_STORE = 1 << 18  # phase 2x's K24: a 2^18-slot fkl
FAN_ORDERS = 100_000
USER_ACCOUNTS_PLAN = os.path.join(_PLANS, "user_accounts.json")
ORDERS_ENRICHED_PLAN = os.path.join(_PLANS, "orders_enriched.json")


def _join_query(plan_path, rows, store):
    """The plan's query on the CPU at a batch of ``rows`` and join stores of
    ``store`` slots: its layouts, kept columns and store builders."""
    from ksql_tpu_torch.execution.steps import plan_from_json
    from ksql_tpu_torch.runtime.lowering import TorchCompiledQuery

    with open(plan_path) as f:
        plan = plan_from_json(json.load(f))
    return TorchCompiledQuery(plan, capacity=rows, device="cpu", table_store_capacity=store)


def _random_values(rng, dtype, n):
    if dtype == np.float64:
        return np.round(rng.uniform(0, 10_000, n), 2)
    if dtype == np.bool_:
        return rng.random(n) < 0.5
    return rng.integers(-(2 ** 30), 2 ** 30, n).astype(dtype)


def _fill_side(rng, st, prefix, cols, slots):
    """Random values (5% null) in ``slots`` of a side's kept columns."""
    for c in cols:
        v = st[f"{prefix}v_{c.name}"]
        v[slots] = _random_values(rng, v.dtype, slots.size)
        st[f"{prefix}m_{c.name}"][slots] = rng.random(slots.size) < 0.95


def _place(torch, hs, st, capacity, ids):
    """Insert the BIGINT keys ``ids`` (a key's repr is its value) into the
    numpy store ``st`` with no probe limit; returns their slots."""
    kh = hs.combine_hash([torch.from_numpy(ids.astype(np.int64))]).numpy()
    slots = fill_store(hs, st["occ"], st["khash"], st["wstart"], capacity, kh, np.zeros(ids.size, np.int64))
    st["key0"][slots] = ids
    return slots


def make_tt_case(torch, rng, dev, n=TT_ROWS, capacity=TT_STORE, users=TT_USERS, accounts=TT_ACCOUNTS):
    """Phase 2x's table-table case: user_accounts' two-sided store of
    ``capacity`` slots holding ``users`` users (side l) and ``accounts`` of
    them with an account (side r), 5% of each side deleted (not live), a
    populated dump row; and a batch of ``n`` user changes (80% of existing
    users, 20% of new ids, a tenth of the batch on one hot id, 10%
    deletes, 1% padding rows), which K1's table mode and K2 place on the
    card.  Returns the query, the store, its scratch, the slots and the
    batch's touched, delete, act and (data, valid) per kept column."""
    from ksql_tpu_torch.ops import hash_store as hs
    from ksql_tpu_torch.state import state_from_numpy, state_to_numpy

    q = _join_query(USER_ACCOUNTS_PLAN, n, capacity)
    st = state_to_numpy(q._init_tt_store("cpu"))
    slots = _place(torch, hs, st, capacity, np.arange(users, dtype=np.int64))
    st["l_live"][slots] = rng.random(users) > 0.05
    _fill_side(rng, st, "l_", q.tt_cols["l"], np.append(slots, capacity))
    acc = slots[rng.permutation(users)[:accounts]]
    st["r_live"][acc] = rng.random(accounts) > 0.05
    _fill_side(rng, st, "r_", q.tt_cols["r"], np.append(acc, capacity))
    store = state_from_numpy(st, dev)
    keys = np.where(rng.random(n) < 0.8, rng.integers(0, users, n), rng.integers(users, users + n // 4, n))
    keys[rng.random(n) < 0.1] = keys[0]
    kr = torch.from_numpy(keys.astype(np.int64)).to(dev).reshape(1, n)
    row_valid = torch.from_numpy(rng.random(n) > 0.01).to(dev)
    touched, khash, base = hs.table_prologue(kr, torch.ones_like(kr, dtype=torch.bool), row_valid, capacity)
    scratch = hs.init_table_scratch(capacity, dev)
    slots_b = hs.probe_insert(store, scratch, capacity, base, khash, torch.zeros_like(khash), kr,
                              torch.zeros(n, dtype=torch.int32, device=dev), touched)
    values = {}
    for c in q.tt_cols["l"]:
        dt = st[f"l_v_{c.name}"].dtype
        values[c.name] = (torch.from_numpy(_random_values(rng, dt, n)).to(dev),
                          torch.from_numpy(rng.random(n) < 0.95).to(dev))
    return dict(query=q, store=store, scratch=scratch, slots=slots_b, touched=touched,
                delete=torch.from_numpy(rng.random(n) < 0.1).to(dev),
                act=torch.from_numpy(rng.random(n) < 0.98).to(dev), values=values)


def tt_side_cols(c):
    """K9 side mode's columns of make_tt_case's batch into store side l."""
    st = c["store"]
    return [(st[f"l_v_{name}"], st[f"l_m_{name}"], d, v, True) for name, (d, v) in c["values"].items()]


def make_fkr_case(torch, rng, dev, n=TT_ROWS, capacity=TT_STORE, users=TT_USERS):
    """Phase 2x's K8 live-mode case: orders_enriched's right store (the
    customers) of ``capacity`` slots holding ``users`` keys, 10% of them
    deleted (found, not live), 5% graves; and ``n`` foreign keys: 70% of
    stored customers, 25% absent, 5% null.  Returns the query, the store,
    the keys' reprs and valid bits, and the store as numpy."""
    from ksql_tpu_torch.ops import hash_store as hs
    from ksql_tpu_torch.state import state_from_numpy, state_to_numpy

    q = _join_query(ORDERS_ENRICHED_PLAN, n, capacity)
    st = state_to_numpy(q._init_fk_store("r", "cpu"))
    ids = np.arange(users, dtype=np.int64)
    slots = _place(torch, hs, st, capacity, ids)
    st["live"][slots] = rng.random(users) > 0.1
    _fill_side(rng, st, "", q.fk_cols["r"], np.append(slots, capacity))
    graves = slots[rng.random(users) < 0.05]
    st["occ"][graves] = False
    st["grave"][graves] = True
    st["live"][graves] = False
    fk = np.where(rng.random(n) < 0.7, rng.integers(0, users, n), rng.integers(users, 2 * users, n))
    return dict(query=q, store=state_from_numpy(st, dev), st=st,
                fk=torch.from_numpy(fk.astype(np.int64)).to(dev),
                valid=torch.from_numpy(rng.random(n) > 0.05).to(dev))


def make_fanout_case(torch, rng, dev, capacity=FAN_STORE, orders=FAN_ORDERS, customers=ORDER_CUSTOMERS):
    """Phase 2x's K24 case: orders_enriched's left store of ``capacity``
    slots holding ``orders`` orders whose customers are zipf(1.3) over
    ``customers`` (phase 16's traffic), 5% of them deleted and 2% with a
    null customer, and the dump row holding the hottest customer (never
    live).  Returns the query, the store, the hottest customer and the
    store as numpy."""
    from ksql_tpu_torch.ops import hash_store as hs
    from ksql_tpu_torch.state import state_from_numpy, state_to_numpy

    q = _join_query(ORDERS_ENRICHED_PLAN, 1, capacity)
    st = state_to_numpy(q._init_fk_store("l", "cpu"))
    slots = _place(torch, hs, st, capacity, np.arange(orders, dtype=np.int64))
    cust = rng.zipf(1.3, orders).astype(np.int64) % customers
    st["fkrepr"][slots] = cust
    st["fkvalid"][slots] = rng.random(orders) > 0.02
    st["live"][slots] = rng.random(orders) > 0.05
    _fill_side(rng, st, "", q.fk_cols["l"], np.append(slots, capacity))
    hot = int(np.bincount(cust).argmax())
    st["fkrepr"][capacity], st["fkvalid"][capacity] = hot, True
    return dict(query=q, store=state_from_numpy(st, dev), st=st, hot=hot)


def fanout_bytes(st, capacity, krepr, cols):
    """K24's bound from the case's data: the bytes its function needs, the
    three scanned columns (live, fkvalid, fkrepr: 10 bytes a slot) read
    once, and per matching slot its key0 and columns read and its slot
    number, key0 and columns written."""
    match = st["live"] & st["fkvalid"] & (st["fkrepr"] == krepr)
    m = int(match.sum())
    row = sum(st[f"v_{c}"].itemsize + 1 for c in cols)
    return (capacity + 1) * 10 + m * (8 + row) + m * (4 + 8 + row), m


def side_bytes(slots, touched, delete, cols, capacity):
    """K9 side mode's bound from the batch's data: per row its slot and its
    touched, delete and act flags read; per upserting winner (the last
    touched row of its slot) its columns read and its columns and live bit
    written, per deleting winner its live bit; and the dump row's columns
    from the highest row that does not upsert, read and written with its
    live bit.  ``cols`` holds each column's element bytes."""
    n = slots.size
    rows = touched & (slots != capacity)
    last = np.full(capacity + 1, -1)
    np.maximum.at(last, slots[rows], np.nonzero(rows)[0])
    winner = rows & (last[slots] == np.arange(n))
    upserts = int((winner & ~delete).sum())
    deletes = int((winner & delete).sum())
    row = sum(b + 1 for b in cols)
    dump = bool((~(winner & ~delete)).any())
    return n * (4 + 3) + upserts * (row + 1 + row) + deletes + dump * (row + row + 1), upserts + deletes


def make_fk_step_case(torch, hs, rng, dev, capacity=FK_STORE, orders=FK_STEP_ORDERS):
    """Phase 2x's K2 case at phase 19's store: orders_enriched's left store
    of ``capacity`` slots holding ``orders`` orders, 5% of their slots
    graves, and a full probe chain (the MAX_PROBES + 2 slots from one new
    key's base all used).  Returns the store and the key groups: the
    chain's key, stored and grave keys, keys whose base lies in the chain
    and new keys."""
    from ksql_tpu_torch.state import state_from_numpy, state_to_numpy

    q = _join_query(ORDERS_ENRICHED_PLAN, 1, capacity)
    st = state_to_numpy(q._init_fk_store("l", "cpu"))
    ids = np.arange(orders, dtype=np.int64)
    slots = _place(torch, hs, st, capacity, ids)
    g = rng.random(orders) < 0.05
    st["occ"][slots[g]] = False
    st["grave"][slots[g]] = True
    cand = np.arange(10 ** 6, 10 ** 6 + 400_000, dtype=np.int64)
    kh = hs.combine_hash([torch.from_numpy(cand)])
    base = hs.slot_base(kh, torch.zeros_like(kh), capacity).numpy()
    run = (int(base[0]) + np.arange(hs.MAX_PROBES + 2)) & (capacity - 1)
    free = run[~(st["occ"][run] | st["grave"][run])]
    st["occ"][free] = True
    st["khash"][free] = rng.integers(-(2 ** 62), 2 ** 62, free.size)
    st["key0"][free] = rng.integers(2 * 10 ** 6, 3 * 10 ** 6, free.size)
    in_run = cand[1:][np.isin(base[1:], run)][:16]
    return dict(store=state_from_numpy(st, dev), chain=cand[:1], stored=ids[~g], graves=ids[g],
                collide=in_run, new=np.arange(4 * 10 ** 6, 4 * 10 ** 6 + orders, dtype=np.int64))


def fk_step_keys(rng, c, n):
    """``n`` order keys for make_fk_step_case's store: one new order (as
    most of phase 19's steps insert), or 40% stored keys, 10% graves'
    keys, 30% new keys, 5% keys into the chain and the chain's own key
    (which overflows), the rest repeats, in random order."""
    if n == 1:
        return c["new"][:1]
    pick = lambda a, k: a[rng.integers(0, a.size, k)]
    keys = np.concatenate([pick(c["stored"], int(0.4 * n)), pick(c["graves"], int(0.1 * n)),
                           c["new"][: int(0.3 * n)], pick(c["collide"], int(0.05 * n)), c["chain"]])
    return np.concatenate([keys, pick(keys, n - keys.size)])[rng.permutation(n)]


def fk_step_args(torch, hs, keys, active, dev, capacity=FK_STORE):
    """K2's arguments after the store and scratch for the order ``keys``,
    placed as the join step places them (K1's table mode: window 0, null
    bits 0; ``active`` the rows' valid bits)."""
    n = keys.size
    kr = torch.from_numpy(keys.astype(np.int64)).to(dev).reshape(1, n)
    touched, khash, base = hs.table_prologue_plain(kr, torch.ones_like(kr, dtype=torch.bool),
                                                   torch.from_numpy(active).to(dev), capacity)
    return (capacity, base, khash, torch.zeros_like(khash), kr,
            torch.zeros(n, dtype=torch.int32, device=dev), touched)


def insert_bytes(slots, base, active, new_keys, capacity, max_probes):
    """K2's bound from the batch's data (one key column): per row its base,
    hash, window start, key repr, null bits and active flag read and its
    slot written; per active row the probes of its walk, at least one per
    slot from its base to its slot (MAX_PROBES when it overflowed), 18
    bytes each (occ, grave, khash, wstart); per new key its slot's occ,
    grave, khash, wstart, key0 and knull written."""
    placed = active & (slots != capacity)
    probes = int((((slots - base) & (capacity - 1)) + 1)[placed].sum())
    probes += int((active & (slots == capacity)).sum()) * max_probes
    n = slots.size
    return n * (4 + 8 + 8 + 8 + 4 + 1) + n * 4 + probes * 18 + new_keys * (1 + 1 + 8 + 8 + 8 + 4), probes


def phase_table_join_kernels(torch, seed):
    """Phase 2x: K8's gather mode and K9's side mode on 65,536 user changes
    into a 2^18-slot user_accounts store (100,000 keys on each side),
    K8's live mode on 65,536 foreign keys against a 2^18-slot customers
    store, and K24 over a 2^18-slot orders store (100,000 orders, zipf(1.3)
    customers) for the hottest customer and for one that has none, and K2
    at phase 19's shapes (one order key, and 1,024) into a 2^16-slot
    orders store; each against its twin on the card.  Returns ``({kernel:
    {mode or shape: record}}, extra records)``."""
    from ksql_tpu_torch.ops import hash_store as hs
    from ksql_tpu_torch.ops import table_join as tj

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(seed + 50)
    recs: dict = {}
    extra: dict = {}

    def done(kernel, mode, rec, what, into=None):
        rec = dict(rec, max_abs_err=rec.get("max_abs_err", 0.0))
        if into is None:
            recs.setdefault(kernel, {})[mode] = rec
        else:
            extra[into] = rec
        _report("2x", f"{kernel}[{mode}] ({what})", rec)

    # ---- K8 gather mode: the accounts side at the user changes' slots
    c = make_tt_case(torch, rng, dev, TT_ROWS, TT_STORE, TT_USERS, TT_USERS)
    st, cap, slots = c["store"], TT_STORE, c["slots"]
    n = slots.shape[0]
    rcols = [col.name for col in c["query"].tt_cols["r"]]
    got = hs.probe_gather(st, cap, slots, st["r_live"], rcols, "r_")
    want = hs.probe_gather_plain(st, cap, slots, st["r_live"], rcols, "r_")
    _assert_equal(torch, "probe_find[gather].o_live", got[1], want[1])
    for k in want[0]:
        _assert_equal(torch, f"probe_find[gather].{k}", got[0][k], want[0][k])
    joined = int(want[1].sum())
    require(0.5 * n < joined < 0.9 * n, f"probe_find[gather]: {joined} of {n} changes meet a live account")
    gbytes = n * (4 + 1) + n * (1 + 9 * len(rcols)) * 2
    done("probe_find", "gather", measure(
        torch, "probe_find", lambda: hs.probe_gather(st, cap, slots, st["r_live"], rcols, "r_"),
        lambda: hs.probe_gather_plain(st, cap, slots, st["r_live"], rcols, "r_"), gbytes, 0,
        library=lambda: [st[f"r_{p}_{name}"].index_select(0, slots.long()) for name in rcols
                         for p in ("v", "m")] + [st["r_live"].index_select(0, slots.long())]),
        f"{n} user changes over {cap} slots, {joined} meet a live account, {len(rcols)} columns; "
        "yardstick index_select per column")

    # ---- K9 side mode: the user changes into side l
    keys = ["l_live"] + [f"l_{p}_{name}" for name in c["values"] for p in ("v", "m")]
    saved = {k: st[k].clone() for k in keys}

    def side(plain):
        args = (cap, slots, c["touched"], c["delete"], c["act"], tt_side_cols(c))
        if plain:
            hs.upsert_side_plain(st["l_live"], *args)
        else:
            hs.upsert_side(st["l_live"], c["scratch"], *args)

    side(False)
    work = {k: st[k].clone() for k in keys}
    for k in keys:
        st[k].copy_(saved[k])
    side(True)
    for k in keys:
        _assert_equal(torch, f"table_upsert[side].{k}", work[k], st[k])
    require(bool((c["scratch"]["last"] == -1).all()), "table_upsert[side]: last-writer cells not clean")
    ncols = len(c["values"])
    sbytes, winners = side_bytes(slots.cpu().numpy(), c["touched"].cpu().numpy(),
                                 c["delete"].cpu().numpy(), [d.element_size() for d, _v in c["values"].values()],
                                 cap)
    done("table_upsert", "side", measure(
        torch, "table_upsert", lambda: side(False), lambda: side(True), sbytes, 0,
        reset=lambda: [st[k].copy_(saved[k]) for k in keys]),
        f"{n} user changes into {winners} slots (the last change per key wins), {ncols} columns")
    del c, st, saved, work

    # ---- K8 live mode: foreign keys against the customers store
    c = make_fkr_case(torch, rng, dev, TT_ROWS, TT_STORE, TT_USERS)
    st, fk, valid = c["store"], c["fk"], c["valid"]
    n = fk.shape[0]
    cols = [col.name for col in c["query"].fk_cols["r"]]
    args = (st, TT_STORE, fk, valid, valid, cols)
    got = hs.probe_find(*args, live=st["live"])
    want = hs.probe_find_gather_plain(*args, live=st["live"])
    for k in want[0]:
        _assert_equal(torch, f"probe_find[live].{k}", got[0][k], want[0][k])
    _assert_equal(torch, "probe_find[live].key0", got[1], want[1])
    _assert_equal(torch, "probe_find[live].found", got[2], want[2])
    found = int(want[2].sum())
    reads = find_walk_keys(torch, hs, c["st"], TT_STORE, fk.cpu().numpy(), valid.cpu().numpy())
    done("probe_find", "live", measure(
        torch, "probe_find", lambda: hs.probe_find(*args, live=st["live"]),
        lambda: hs.probe_find_gather_plain(*args, live=st["live"]),
        n * (8 + 1 + 1) + n * (8 + 1 + 9 * len(cols)) + reads * 18, reads * 6, plain_reps=10,
        per_call=1),
        f"{n} foreign keys over {TT_STORE} slots, {found} found live, {reads} slot reads")
    # the pair call: these keys as the new foreign keys, the same keys one
    # row on as the old ones (a batch of left changes that move)
    sets = live_pair_sets(torch, fk, valid)
    rec, what = time_live_pair(torch, hs, st, TT_STORE, c["st"], sets, cols)
    done("probe_find", "live_pair", rec, f"{n} left changes over {TT_STORE} slots: {what}")
    del c, st

    # ---- K24: the hottest customer's orders, and a customer with none
    c = make_fanout_case(torch, rng, dev, FAN_STORE, FAN_ORDERS)
    st = c["store"]
    lcols = [col.name for col in c["query"].fk_cols["l"]]
    touched = torch.ones(1, dtype=torch.bool, device=dev)
    for case, cust in (("hot", c["hot"]), ("none", ORDER_CUSTOMERS + 7)):
        krepr = torch.tensor([cust], dtype=torch.int64, device=dev)
        got = tj.fk_fanout(st, FAN_STORE, krepr, touched, lcols)
        want = tj.fk_fanout_plain(st, FAN_STORE, krepr, touched, lcols)
        _assert_equal(torch, f"fk_fanout[{case}].slots", got[0], want[0])
        _assert_equal(torch, f"fk_fanout[{case}].key0", got[2], want[2])
        for k in want[1]:
            _assert_equal(torch, f"fk_fanout[{case}].{k}", got[1][k], want[1][k])
        fbytes, m = fanout_bytes(c["st"], FAN_STORE, cust, lcols)
        require(int(want[0].shape[0]) == m and (m > 0) == (case == "hot"),
                f"fk_fanout[{case}]: {int(want[0].shape[0])} matches, numpy {m}")
        require(FAN_STORE not in want[0].tolist(), "fk_fanout: the dump slot matched")

        def library(krepr=krepr):
            match = st["live"] & st["fkvalid"] & (st["fkrepr"] == krepr[0]) & touched[0]
            idx = torch.nonzero(match).squeeze(1)
            return [st[f"{p}_{name}"].index_select(0, idx) for name in lcols for p in ("v", "m")] + [
                st["key0"].index_select(0, idx)]

        done("fk_fanout", "fanout", measure(
            torch, "fk_fanout", lambda krepr=krepr: tj.fk_fanout(st, FAN_STORE, krepr, touched, lcols),
            lambda krepr=krepr: tj.fk_fanout_plain(st, FAN_STORE, krepr, touched, lcols), fbytes, 0,
            library=library, per_call=fanout_records(tj)),
            f"{FAN_ORDERS} orders over {FAN_STORE + 1} slots, customer {cust}: {m} matches in slot order; "
            "yardstick nonzero + index_select", into=None if case == "hot" else "fk_fanout_none")
    del c, st

    # ---- K2 at phase 19's shapes: one order a step, and 1,024 orders,
    # into its 2^16-slot store with graves and a full probe chain
    c = make_fk_step_case(torch, hs, rng, dev)
    store0 = c["store"]
    scratch = hs.init_table_scratch(FK_STORE, dev)
    one = np.ones(1, bool)
    for shape, keys in (("chain", c["chain"]), ("stored", c["stored"][:1]), ("grave", c["graves"][:1]),
                        ("collide", c["collide"][:1])):
        got = _check_insert(torch, hs, f"probe_insert[1, {shape}]", store0, scratch,
                            fk_step_args(torch, hs, keys, one, dev))
        require((int(got["overflow"]) > int(store0["overflow"])) == (shape == "chain"),
                f"probe_insert[1, {shape}]: overflow {int(got['overflow'])}, before {int(store0['overflow'])}")
    for n in (1, 1024):
        args = fk_step_args(torch, hs, fk_step_keys(rng, c, n), rng.random(n) > 0.05 if n > 1 else one, dev)
        got = _check_insert(torch, hs, f"probe_insert[{n}]", store0, scratch, args)
        new_keys = int((got["occ"] & ~store0["occ"] & ~store0["grave"]).sum())
        ibytes, probes = insert_bytes(got["slots"], args[1].cpu().numpy(), args[6].cpu().numpy(), new_keys,
                                      FK_STORE, hs.MAX_PROBES)
        if n > 1:
            require(int(got["overflow"]) > int(store0["overflow"]) and new_keys > 0
                    and int((store0["grave"] & ~got["grave"]).sum()) > 0,
                    f"probe_insert[{n}]: the batch should overflow, claim new slots and reclaim graves")
        work = _clone(store0)
        done("probe_insert", f"per_record_{n}", measure(
            torch, "probe_insert", lambda args=args: hs.probe_insert(work, scratch, *args),
            lambda args=args: hs.probe_insert_plain(work, *args), ibytes, n * 40,
            reset=lambda: _restore(work, store0), plain_reps=10),
            f"{n} order key{'s' if n > 1 else ''} into {FK_STORE} slots ({FK_STEP_ORDERS} orders, 5% graves, "
            f"a full probe chain), {new_keys} new, {probes} probes, overflow "
            f"{int(got['overflow']) - int(store0['overflow'])}")
    for kernel, shape, rec, what in per_record_kernels(torch, seed):
        done(kernel, shape, rec, what)
    return recs, extra


def fanout_records(tj):
    """K24's kernel records a call: one for the single pass; None for an
    earlier tree (timed against this one by ``scripts/torch_slice_times.py``),
    whose count and scan launch a write only when something matches: its
    records are counted from one fenced call."""
    return 1 if hasattr(tj, "fanout_plan") else None


def live_pair_sets(torch, fk, valid):
    """A batch of left changes from foreign keys ``fk``: new keys ``fk``,
    old keys the same column one row on, each looked up where valid."""
    old, old_valid = torch.roll(fk, 1).contiguous(), torch.roll(valid, 1).contiguous()
    return [(fk, valid, valid), (old, old_valid, old_valid)]


def time_live_pair(torch, hs, st, cap, st_np, sets, cols):
    """K8's pair call (a left change's new and old foreign key in one
    launch) against two single twin calls, exact, then timed; an earlier
    tree without the pair call is timed as its two single live-mode
    calls.  Returns ``(record, what)``."""
    if hasattr(hs, "probe_find_live_pair"):
        def fn():
            return hs.probe_find_live_pair(st, cap, sets, cols, st["live"])
        per_call = 1
    else:
        def fn():
            return [hs.probe_find(st, cap, *s, cols, live=st["live"]) for s in sets]
        per_call = 2
    got = fn()
    want = [hs.probe_find_gather_plain(st, cap, *s, cols, live=st["live"]) for s in sets]
    found, reads, n = 0, 0, 0
    for k, (g, w, (fk, valid, _a)) in enumerate(zip(got, want, sets)):
        for name in w[0]:
            _assert_equal(torch, f"probe_find[live_pair {k}].{name}", g[0][name], w[0][name])
        _assert_equal(torch, f"probe_find[live_pair {k}].key0", g[1], w[1])
        _assert_equal(torch, f"probe_find[live_pair {k}].found", g[2], w[2])
        found += int(w[2].sum())
        reads += find_walk_keys(torch, hs, st_np, cap, fk.cpu().numpy(), valid.cpu().numpy())
        n += fk.shape[0]
    rec = measure(torch, "probe_find", fn,
                  lambda: [hs.probe_find_gather_plain(st, cap, *s, cols, live=st["live"]) for s in sets],
                  n * (8 + 1 + 1) + n * (8 + 1 + 9 * len(cols)) + reads * 18, reads * 6, plain_reps=10,
                  per_call=per_call)
    return rec, (f"{n} lookups in {per_call} launch{'es' if per_call > 1 else ''}, {found} found live, "
                 f"{reads} slot reads")


def per_record_kernels(torch, seed):
    """Phase 2x at phase 19's shapes, one change a step: K1's table mode on
    one customer key, K8's live mode on one foreign key and K9's side mode
    on one change, each into orders_enriched's 2^16-slot customers store
    holding FK_USERS customers (10% deleted, 5% graves), and K24 for the
    hottest customer over its 2^16-slot orders store of FK_ORDERS orders;
    each against its twin.  Returns ``[(kernel, shape, record, what)]``."""
    from ksql_tpu_torch.ops import hash_store as hs
    from ksql_tpu_torch.ops import table_join as tj

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(seed + 53)
    out = []
    c = make_fkr_case(torch, rng, dev, 1, FK_STORE, FK_USERS)
    st, cap = c["store"], FK_STORE
    cols = [col.name for col in c["query"].fk_cols["r"]]
    fk = torch.full((1,), int(rng.integers(0, FK_USERS)), dtype=torch.int64, device=dev)
    kr = fk.reshape(1, 1)
    one = torch.ones(1, dtype=torch.bool, device=dev)
    kv = one.reshape(1, 1)
    # ---- K1's table mode: the change's key
    got = hs.table_prologue(kr, kv, one, cap)
    for g, w in zip(got, hs.table_prologue_plain(kr, kv, one, cap)):
        _assert_equal(torch, "row_prologue[table, 1]", g, w)
    out.append(("row_prologue", "table_per_record_1", measure(
        torch, "row_prologue", lambda: hs.table_prologue(kr, kv, one, cap),
        lambda: hs.table_prologue_plain(kr, kv, one, cap), 8 + 1 + 1 + 1 + 8 + 4, 30),
        f"one customer key into {cap} slots"))
    touched, khash, base = got
    # ---- K8's live mode: a left change's new and old foreign key against
    # the customers (the pair call; an earlier tree's two single calls)
    old_fk = torch.full((1,), int(rng.integers(0, FK_USERS)), dtype=torch.int64, device=dev)
    rec, what = time_live_pair(torch, hs, st, cap, c["st"], [(fk, one, one), (old_fk, one, one)], cols)
    out.append(("probe_find", "live_pair_per_record_1", rec,
                f"a left change's new and old foreign key over {cap} slots ({FK_USERS} customers): "
                f"{what}"))
    # ---- K9's side mode: the change written into the customers store
    scratch = hs.init_table_scratch(cap, dev)
    slots = hs.probe_insert(st, scratch, cap, base, khash, torch.zeros_like(khash), kr,
                            torch.zeros(1, dtype=torch.int32, device=dev), touched)
    values = {name: (torch.from_numpy(_random_values(rng, c["st"][f"v_{name}"].dtype, 1)).to(dev),
                     one.clone()) for name in cols}
    delete = torch.zeros(1, dtype=torch.bool, device=dev)
    keys = ["live"] + [f"{p}_{name}" for name in cols for p in ("v", "m")]
    saved = {k: st[k].clone() for k in keys}
    side_cols = [(st[f"v_{name}"], st[f"m_{name}"], d, v, True) for name, (d, v) in values.items()]

    def side(plain):
        if plain:
            hs.upsert_side_plain(st["live"], cap, slots, touched, delete, one, side_cols)
        else:
            hs.upsert_side(st["live"], scratch, cap, slots, touched, delete, one, side_cols)

    def reset():
        for k in keys:
            st[k].copy_(saved[k])

    side(False)
    work = {k: st[k].clone() for k in keys}
    reset()
    side(True)
    for k in keys:
        _assert_equal(torch, f"table_upsert[side, 1].{k}", work[k], st[k])
    require(bool((scratch["last"] == -1).all()), "table_upsert[side, 1]: last-writer cells not clean")
    sbytes, _w = side_bytes(slots.cpu().numpy(), touched.cpu().numpy(), delete.cpu().numpy(),
                            [d.element_size() for d, _v in values.values()], cap)
    out.append(("table_upsert", "side_per_record_1", measure(
        torch, "table_upsert", lambda: side(False), lambda: side(True), sbytes, 0, reset=reset),
        f"one change into {cap} slots, {len(cols)} columns"))
    reset()
    del c, st
    # ---- K24: the hottest customer's orders
    c = make_fanout_case(torch, rng, dev, cap, FK_ORDERS, FK_USERS)
    st = c["store"]
    lcols = [col.name for col in c["query"].fk_cols["l"]]
    krepr = torch.tensor([c["hot"]], dtype=torch.int64, device=dev)
    got = tj.fk_fanout(st, cap, krepr, one, lcols)
    want = tj.fk_fanout_plain(st, cap, krepr, one, lcols)
    _assert_equal(torch, "fk_fanout[per_record].slots", got[0], want[0])
    for k in want[1]:
        _assert_equal(torch, f"fk_fanout[per_record].{k}", got[1][k], want[1][k])
    fbytes, m = fanout_bytes(c["st"], cap, c["hot"], lcols)

    def library():
        match = st["live"] & st["fkvalid"] & (st["fkrepr"] == krepr[0])
        idx = torch.nonzero(match).squeeze(1)
        return [st[f"{p}_{name}"].index_select(0, idx) for name in lcols for p in ("v", "m")] + [
            st["key0"].index_select(0, idx)]

    out.append(("fk_fanout", "fanout_per_record", measure(
        torch, "fk_fanout", lambda: tj.fk_fanout(st, cap, krepr, one, lcols),
        lambda: tj.fk_fanout_plain(st, cap, krepr, one, lcols), fbytes, 0, library=library,
        per_call=fanout_records(tj)),
        f"{FK_ORDERS} orders over {cap + 1} slots, the hottest customer's {m} matches; "
        "yardstick nonzero + index_select"))
    return out


def _check_insert(torch, hs, name, store0, scratch, args):
    """K2 on a copy of ``store0`` against its twin on another: the slots
    and every store column equal, the claim cells clean after.  Returns
    the kernel's store with its ``slots`` (numpy)."""
    sk, sp = _clone(store0), _clone(store0)
    slots_k = hs.probe_insert(sk, scratch, *args)
    slots_p = hs.probe_insert_plain(sp, *args)
    _assert_equal(torch, f"{name}.slots", slots_k, slots_p)
    for key in store0:
        _assert_equal(torch, f"{name}.{key}", sk[key], sp[key])
    require(bool((scratch["claim"] == hs.INT32_MAX).all()), f"{name}: claim cells not clean")
    return dict(sk, slots=slots_k.cpu().numpy())


def find_walk_keys(torch, hs, st, capacity, krepr, look):
    """K8's walk over BIGINT keys replayed in numpy: the slots it reads."""
    kh = hs.combine_hash([torch.from_numpy(krepr)]).numpy()
    return find_walk(hs, st, capacity, kh, look)


def accounts_traffic(seed, n_blocks=None, rows=None):
    """Phase 18's changelogs: the load (USERS 0..99,999 named ``user<k>``
    in region ``k % 50`` as BASELINE #3's, then ACCOUNTS for 90,000 of them
    with a BALANCE and a TIER), and ``n_blocks`` blocks of ``rows`` changes,
    users in the even blocks and accounts in the odd ones: 70% an update of
    a live row, 20% a delete, 10% a re-insert of a deleted one (an update
    when none is deleted).  Returns ``(load, blocks)``, each a list of
    (topic, key, value dict or None)."""
    n_blocks = n_blocks or TT_UPDATE_BATCHES + TT_BREAKDOWN_BATCHES
    rows = rows or TT_ROWS
    rng = np.random.default_rng(seed + 60)

    def user(k):
        return {"NAME": f"user{k}-{int(rng.integers(0, 1000))}", "REGION": f"r{int(rng.integers(0, N_REGIONS))}"}

    def account(_k=None):
        return {"BALANCE": float(np.round(rng.uniform(0, 100_000), 2)),
                "TIER": TIERS[int(rng.integers(0, len(TIERS)))]}

    acc_ids = rng.permutation(TT_USERS)[:TT_ACCOUNTS]
    load = [("users", k, {"NAME": f"user{k}", "REGION": f"r{k % N_REGIONS}"}) for k in range(TT_USERS)]
    load += [("accounts", int(k), account()) for k in acc_ids]
    # per side its keys, live first: live[:n_live[side]] are live
    keys = {"users": list(range(TT_USERS)), "accounts": [int(k) for k in acc_ids]}
    pos = {side: {k: i for i, k in enumerate(ks)} for side, ks in keys.items()}
    n_live = {side: len(ks) for side, ks in keys.items()}
    make = {"users": user, "accounts": account}

    def swap(side, i, j):
        ks = keys[side]
        ks[i], ks[j] = ks[j], ks[i]
        pos[side][ks[i]], pos[side][ks[j]] = i, j

    blocks = []
    for b in range(n_blocks):
        side = ("users", "accounts")[b % 2]
        ks, block = keys[side], []
        for op in rng.random(rows):
            n = n_live[side]
            if (op >= 0.9 and n < len(ks)) or n == 0:  # a re-insert
                i = int(rng.integers(n, len(ks)))
                k = ks[i]
                swap(side, i, n)
                n_live[side] += 1
                block.append((side, k, make[side](k)))
                continue
            i = int(rng.integers(0, n))
            k = ks[i]
            if 0.7 <= op < 0.9:  # a delete
                swap(side, i, n - 1)
                n_live[side] -= 1
                block.append((side, k, None))
            else:
                block.append((side, k, make[side](k)))
        blocks.append(block)
    return load, blocks


def accounts_model(recs, first=0):
    """USER_ACCOUNTS by a plain dict, change by change: a user change emits
    its row beside the user's live account (nulls without one), or a
    tombstone for a delete; an account change emits the user's row with
    the new account (nulls for a delete) when the user is live, nothing
    otherwise.  Returns (key, value dict or None, ts) per emit, with
    phase 18's timestamps (17 ms a change from change ``first`` on)."""
    users, accounts, out = {}, {}, []
    for i, (topic, k, v) in enumerate(recs, start=first):
        ts = TS0 + 17 * i
        if topic == "users":
            old = users.pop(k, None)
            if v is not None:
                users[k] = v
                a = accounts.get(k, {})
                out.append((k, {**v, "BALANCE": a.get("BALANCE"), "TIER": a.get("TIER")}, ts))
            elif old is not None:
                out.append((k, None, ts))
        else:
            accounts.pop(k, None)
            if v is not None:
                accounts[k] = v
            if k in users:
                a = v or {}
                out.append((k, {**users[k], "BALANCE": a.get("BALANCE"), "TIER": a.get("TIER")}, ts))
    return out


def produce_table_changes(broker, recs, first=0):
    """Changelog records ``(topic, key, value dict or None)`` on their
    topics, 17 ms apart from change number ``first`` on."""
    from ksql_tpu_torch.runtime.topics import Record

    for i, (topic, k, v) in enumerate(recs, start=first):
        value = None if v is None else json.dumps(v, separators=(",", ":"))
        broker.create_topic(topic).produce(Record(key=k, value=value, timestamp=TS0 + 17 * i, partition=0))


def _timed_side_batches(torch, seconds):
    """Patch the executor's join change batch to append its synchronized
    wall seconds to ``seconds``; returns the undo."""
    from ksql_tpu_torch.runtime.device_executor import TorchDeviceExecutor

    run = TorchDeviceExecutor._run_side_batch

    def timed(self):
        t0 = time.perf_counter()
        out = run(self)
        torch.cuda.synchronize()
        seconds.append(time.perf_counter() - t0)
        return out

    TorchDeviceExecutor._run_side_batch = timed
    return lambda: setattr(TorchDeviceExecutor, "_run_side_batch", run)


def join_sink(broker, topic, first=0):
    """A join's sink from record ``first`` on, as (key, value dict or None,
    ts)."""
    return [(int(r.key), None if r.value is None else json.loads(r.value), r.timestamp)
            for r in broker.topic(topic).all_records()[first:]]


def feed_blocks(h, broker, blocks, first, tick=None):
    """Produce each block (in ticks of ``tick`` changes) and poll it
    through the runner, draining at the end of each tick."""
    from ksql_tpu_torch.runner import run_until_quiescent

    i = first
    for block in blocks:
        for start in range(0, len(block), tick or len(block)):
            part = block[start:start + (tick or len(block))]
            produce_table_changes(broker, part, first=i)
            i += len(part)
            run_until_quiescent(h)
            h.executor.drain()
    return i


def phase_user_accounts(torch, plan_json, seed):
    """Phase 18 (and 18b): user_accounts.json (USERS LEFT JOIN ACCOUNTS on
    the key) through ``start_plan``: the load of 100,000 users and 90,000
    accounts run apart, then TT_UPDATE_BATCHES single-sided update
    batches of 65,536 changes (p50/p99 over these) into a 2^18-slot store:
    the sink must equal the dict model change for change, with no
    overflow.  Then 18b: two more update batches under the breakdown's
    timers, and the sink against the model again."""
    from ksql_tpu_torch.runner import start_plan
    from ksql_tpu_torch.runtime.topics import Broker

    load, blocks = accounts_traffic(seed)
    broker = Broker()
    torch.cuda.reset_peak_memory_stats()
    h = start_plan(plan_json, broker, device=DEVICE, capacity=TT_ROWS, table_store_capacity=TT_STORE)
    zero_launches()
    t0 = time.perf_counter()
    nxt = feed_blocks(h, broker, [[r for r in load if r[0] == "users"], [r for r in load if r[0] == "accounts"]], 0)
    load_s = time.perf_counter() - t0
    batch_s = []
    undo = _timed_side_batches(torch, batch_s)
    try:
        t1 = time.perf_counter()
        nxt = feed_blocks(h, broker, blocks[:TT_UPDATE_BATCHES], nxt)
        torch.cuda.synchronize()
        upd_s = time.perf_counter() - t1
    finally:
        undo()
    PATH_LAUNCHES["18"] = read_launches()
    check_path_launches("18", PATH_LAUNCHES["18"])
    peak = torch.cuda.max_memory_allocated()
    q = h.executor.query
    require(int(q.state["ttab"]["overflow"]) == 0, "18: store overflowed")
    require(q.table_grows == 0, f"18: the store grew {q.table_grows} times")
    # the model over phase 18's changes and 18b's, in one pass: 18's emits
    # are those before 18b's first change
    want = accounts_model(load + [r for b in blocks for r in b])
    end_ts = TS0 + 17 * nxt
    n18 = sum(1 for _k, _v, ts in want if ts < end_ts)
    got = join_sink(broker, "USER_ACCOUNTS")
    require(got == want[:n18], f"18: the sink differs from the dict model ({len(got)} vs {n18} records)")
    n_upd = TT_UPDATE_BATCHES * TT_ROWS
    require(len(batch_s) == TT_UPDATE_BATCHES, f"18: {len(batch_s)} update batches ran")
    p50, p99 = np.percentile(np.array(batch_s) * 1e3, [50, 99])
    pads = sum(1 for _k, v, _t in got if v is not None and v["BALANCE"] is None and v["TIER"] is None)
    print(f"[18] user_accounts: load {len(load)} changes in {load_s:.3f} s, then {n_upd} changes in "
          f"{TT_UPDATE_BATCHES} single-sided batches of {TT_ROWS} in {upd_s:.3f} s = {n_upd / upd_s:.1f} "
          f"changes/s; update batch p50 {p50:.3f} ms p99 {p99:.3f} ms; {len(got)} sink records ({pads} "
          f"padded, {sum(v is None for _k, v, _t in got)} tombstones); peak device memory {peak} B; sink "
          "equals the dict model change for change, overflow 0")
    rec = dict(changes_per_s=n_upd / upd_s, p50_ms=p50, p99_ms=p99, load_s=load_s, peak_bytes=peak,
               sink_records=len(got))

    # ---- 18b: two more update batches under the breakdown's timers
    more = blocks[TT_UPDATE_BATCHES:]

    def drive():
        t = time.perf_counter()
        feed_blocks(h, broker, more, nxt)
        torch.cuda.synchronize()
        return time.perf_counter() - t

    breakdown = phase_breakdown(torch, drive, len(more), "18b")
    require(join_sink(broker, "USER_ACCOUNTS", n18) == want[n18:], "18b: the sink differs from the dict model")
    require(int(q.state["ttab"]["overflow"]) == 0, "18b: store overflowed")
    return rec, breakdown


def phase_tt_growth(torch, plan_json, seed):
    """Phase 18g: user_accounts.json from a 2^14-slot store, in ticks of
    4,096 changes (users, then their accounts, alternating; each tick
    polled and drained) at phase 18's batch size, so the load check
    doubles the two-sided store while they load (host rebuilds on card
    tensors); the sink must equal the dict model, no overflow."""
    from ksql_tpu_torch.runner import start_plan
    from ksql_tpu_torch.runtime.topics import Broker

    rng = np.random.default_rng(seed + 61)
    blocks = []
    for t in range(TT_GROW_TICKS // 2):
        ids = np.arange(t * TT_GROW_TICK, (t + 1) * TT_GROW_TICK)
        blocks.append([("users", int(k), {"NAME": f"user{k}", "REGION": f"r{k % N_REGIONS}"}) for k in ids])
        blocks.append([("accounts", int(k), {"BALANCE": float(np.round(rng.uniform(0, 100_000), 2)),
                                             "TIER": TIERS[int(rng.integers(0, len(TIERS)))]})
                       for k in ids if rng.random() < 0.9])
    broker = Broker()
    h = start_plan(plan_json, broker, device=DEVICE, capacity=TT_ROWS, table_store_capacity=TT_GROW_STORE)
    zero_launches()
    t0 = time.perf_counter()
    feed_blocks(h, broker, blocks, 0)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    PATH_LAUNCHES["18g"] = read_launches()
    check_path_launches("18g", PATH_LAUNCHES["18g"])
    q = h.executor.query
    require(q.table_grows >= 2, f"18g: the store grew {q.table_grows} times ({q.tt_store_capacity} slots)")
    require(int(q.state["ttab"]["overflow"]) == 0, "18g: store overflowed")
    recs = [r for b in blocks for r in b]
    got = join_sink(broker, "USER_ACCOUNTS")
    require(got == accounts_model(recs), f"18g: the sink differs from the dict model ({len(got)} records)")
    print(f"[18g] tt store growth: {len(recs)} changes in {len(blocks)} ticks in {secs:.3f} s; {q.table_grows} "
          f"grows {TT_GROW_STORE} -> {q.tt_store_capacity} slots (host rebuild s "
          f"{[round(x, 4) for x in q.table_rebuild_seconds]}); {len(got)} sink records equal the dict model, "
          "overflow 0")
    return dict(grows=q.table_grows, rebuild_seconds=q.table_rebuild_seconds, seconds=secs)


def orders_enriched_traffic(seed):
    """Phase 19's changelogs: USERS 0..9,999 (BASELINE #3's names and
    regions), ORDERS 0..16,383 of zipf(1.3) customers (phase 16's traffic:
    a status, an amount in cents), then FK_USER_CHANGES user changes (90%
    a rename, 10% a delete; a change of a deleted user re-inserts it), then
    FK_ORDER_CHANGES order changes (50% a move to another customer, 25% a
    new amount, 25% a delete; a change of a deleted order re-inserts it).
    The user changes draw their customers uniformly, the first one the
    hottest.
    Returns four lists of (topic, key, value dict or None)."""
    rng = np.random.default_rng(seed + 62)
    users = [("users", k, {"NAME": f"user{k}", "REGION": f"r{k % N_REGIONS}"}) for k in range(FK_USERS)]
    cust = rng.zipf(1.3, FK_ORDERS).astype(np.int64) % FK_USERS
    orders = {k: {"CUSTOMER_ID": int(cust[k]), "STATUS": STATUSES[int(rng.integers(0, 3))],
                  "AMOUNT": float(rng.integers(100, 100_000)) / 100} for k in range(FK_ORDERS)}
    load = [("orders", k, dict(v)) for k, v in orders.items()]
    live = set(range(FK_USERS))
    uchanges = []
    # customers drawn uniformly, the first change the hottest customer's
    # (a fifth or so of the orders): each change fans out over its orders
    picks = rng.integers(0, FK_USERS, FK_USER_CHANGES)
    picks[0] = np.bincount(cust).argmax()
    for k in picks.tolist():
        if k in live and rng.random() < 0.1:
            live.discard(k)
            uchanges.append(("users", k, None))
        else:
            live.add(k)
            uchanges.append(("users", k, {"NAME": f"user{k}-{int(rng.integers(0, 1000))}",
                                          "REGION": f"r{k % N_REGIONS}"}))
    ochanges = []
    for k in rng.integers(0, FK_ORDERS, FK_ORDER_CHANGES).tolist():
        op = rng.random()
        if k in orders and op >= 0.75:
            del orders[k]
            ochanges.append(("orders", k, None))
            continue
        v = dict(orders.get(k) or {"CUSTOMER_ID": int(cust[k]), "STATUS": "NEW", "AMOUNT": 1.0})
        if op < 0.5:
            v["CUSTOMER_ID"] = int(rng.zipf(1.3) % FK_USERS)
        else:
            v["AMOUNT"] = float(rng.integers(100, 100_000)) / 100
        orders[k] = v
        ochanges.append(("orders", k, v))
    return users, load, uchanges, ochanges


def orders_enriched_model(recs):
    """ORDERS_ENRICHED by a plain dict, change by change (LEFT join on the
    foreign key): an order change emits its row beside its customer's
    live row (nulls without one), or a tombstone for a delete; a customer
    change re-emits every live order of that customer with the new
    customer row (nulls for a delete), in the order of the repr of the
    order's key.  Returns (key, value dict or None, ts) per emit."""
    users, orders, by_cust, out = {}, {}, {}, []
    for i, (topic, k, v) in enumerate(recs):
        ts = TS0 + 17 * i
        if topic == "users":
            users.pop(k, None)
            if v is not None:
                users[k] = v
            u = v or {}
            for o in sorted(by_cust.get(k, ()), key=lambda o: repr((o, (o,)))):
                row = orders[o]
                out.append((o, {"AMOUNT": row["AMOUNT"], "STATUS": row["STATUS"], "NAME": u.get("NAME"),
                                "REGION": u.get("REGION")}, ts))
            continue
        old = orders.pop(k, None)
        if old is not None:
            by_cust[old["CUSTOMER_ID"]].discard(k)
        if v is None:
            if old is not None:
                out.append((k, None, ts))
            continue
        orders[k] = v
        by_cust.setdefault(v["CUSTOMER_ID"], set()).add(k)
        u = users.get(v["CUSTOMER_ID"], {})
        out.append((k, {"AMOUNT": v["AMOUNT"], "STATUS": v["STATUS"], "NAME": u.get("NAME"),
                        "REGION": u.get("REGION")}, ts))
    return out


def phase_orders_enriched(torch, plan_json, seed):
    """Phase 19: orders_enriched.json (ORDERS LEFT JOIN USERS on the
    order's CUSTOMER_ID) one change a step (the reference refuses a
    batched foreign-key join) into 2^16-slot stores: 2,500 users, 4,096
    orders, then 512 user changes (each fans out over that customer's
    orders through K24) and 512 order changes; the sink must equal the
    dict model change for change, no overflow.  Prints records/s and the
    p50/p99 step."""
    from ksql_tpu_torch.runner import start_plan
    from ksql_tpu_torch.runtime.topics import Broker

    users, load, uchanges, ochanges = orders_enriched_traffic(seed)
    broker = Broker()
    h = start_plan(plan_json, broker, device=DEVICE, capacity=1, table_store_capacity=FK_STORE)
    step_s: list = []
    q = h.executor.query
    steps = {"l": 0, "r": 0}
    process_fk = q.process_fk

    def counted(side, *a, **kw):
        steps[side] += 1
        return process_fk(side, *a, **kw)

    q.process_fk = counted
    zero_launches()
    undo = _timed_side_batches(torch, step_s)
    t0 = time.perf_counter()
    try:
        nxt = feed_blocks(h, broker, [users, load], 0)
        n_load = len(step_s)
        t1 = time.perf_counter()
        feed_blocks(h, broker, [uchanges, ochanges], nxt)
        torch.cuda.synchronize()
        chg_s = time.perf_counter() - t1
    finally:
        undo()
    secs = time.perf_counter() - t0
    PATH_LAUNCHES["19"] = read_launches()
    check_path_launches("19", PATH_LAUNCHES["19"])
    # one K8 launch a left change (its new and old foreign key), one K24
    # launch a right change
    got_l, got_r = PATH_LAUNCHES["19"]["probe_find"]["live"], PATH_LAUNCHES["19"]["fk_fanout"]["all"]
    require(got_l == steps["l"] and got_r == steps["r"],
            f"19: K8 live {got_l} launches for {steps['l']} left steps, K24 {got_r} for {steps['r']} right steps")
    del q.process_fk
    require(int(q.state["fkl"]["overflow"]) + int(q.state["fkr"]["overflow"]) == 0, "19: a store overflowed")
    recs = users + load + uchanges + ochanges
    got = join_sink(broker, "ORDERS_ENRICHED")
    want = orders_enriched_model(recs)
    require(got == want, f"19: the sink differs from the dict model ({len(got)} vs {len(want)} records)")
    n_fan = sum(1 for _k, _v, t in got if (t - TS0) // 17 in range(len(users) + len(load),
                                                                    len(users) + len(load) + len(uchanges)))
    p50, p99 = np.percentile(np.array(step_s[n_load:]) * 1e3, [50, 99])
    n = len(recs)
    print(f"[19] orders_enriched: {n} changes one a step in {secs:.3f} s = {n / secs:.1f} records/s "
          f"({FK_USERS} users and {FK_ORDERS} orders, then {len(uchanges)} user changes fanning out to "
          f"{n_fan} rows and {len(ochanges)} order changes in {chg_s:.3f} s); change step p50 {p50:.3f} ms "
          f"p99 {p99:.3f} ms; {len(got)} sink records equal the dict model, overflow 0, "
          f"{q.fk_store_capacity} slots")
    return dict(records_per_s=n / secs, p50_ms=p50, p99_ms=p99, change_s=chg_s, fanned_out=n_fan,
                sink_records=len(got), grows=q.table_grows)


# ------------------------------------------------- phases 2p, 20, 21: push taps
TAP_LANES = 256  # bench_push_fanout's widest tap count (bench.py:971)
TAP_ROWS = 4096  # the registry's rows a poll (ksql.push.registry.max.poll.rows)
TAP_MAX_LANES = 4096  # the fused capacity's maximum
TAP_MAX_ROWS = 8192  # the ring's size
TAP_CORPUS_LANES = 64  # lanes of each of 2p's corpus families (cut from 256 for the script's time)
TAP_NULLS = 0.05
FANOUT_EVENTS = 10_000  # bench.py:985's count at 256 taps
FANOUT_ROUND = 1024  # bench.py:922, events produced between poll rounds
FANOUT_URL_TAPS = 16
FANOUT_LIMIT_TAPS = 4
FANOUT_LIMIT = 100
LISTENER_ROUND = 4096  # the upstream's capacity and a listener advance's poll
LISTENER_ROUNDS = 16
PV_STREAM_PLAN = os.path.join(_PLANS, "pv_stream.json")


def tap_template(kind, source):
    """The committed tap template ``tap_<kind>_<source>.json`` (kind: mod,
    url or like; source: page_views or pv_stream)."""
    with open(os.path.join(_PLANS, f"tap_{kind}_{source}.json")) as f:
        return json.load(f)


def tap_plan(template, values):
    """A session's plan JSON: the template with each literal whose value is
    a key of ``values`` set to its value, as the reference's parser types
    it (an integer outside int32 is a LongLiteral)."""
    def walk(o):
        if isinstance(o, dict):
            if o.get("node") in ("IntegerLiteral", "LongLiteral", "StringLiteral"):
                v = o["fields"]["value"]
                if v in values:
                    new = values[v]
                    node = ("StringLiteral" if isinstance(new, str) else
                            "IntegerLiteral" if -(1 << 31) <= new < (1 << 31) else "LongLiteral")
                    return {"fields": {"value": new}, "node": node}
                return o
            return {k: walk(x) for k, x in o.items()}
        if isinstance(o, list):
            return [walk(x) for x in o]
        return o

    return walk(template)


def _pv_columns(rng, n, nulls=TAP_NULLS):
    """PAGE_VIEWS-shaped values (bench.py:119-146): zipf(1.3) URL indexes
    over 50,000, USER_ID 0..999, VIEWTIME 17 ms apart; each column NULL
    with probability ``nulls`` (None in the object arrays)."""
    url = rng.zipf(1.3, size=n).astype(np.int64) % N_URLS
    uid = rng.integers(0, 1000, n).astype(object)
    vt = (TS0 + 17 * np.arange(n, dtype=np.int64)).astype(object)
    urls = np.array([f"/page/{k}" for k in url], dtype=object)
    for col in (urls, uid, vt):
        col[rng.random(n) < nulls] = None
    return urls, uid, vt


def _corpus_predicates(pex):
    """2p's corpus families over PAGE_VIEWS: per family a function of the
    lane's index to its predicate (port expressions)."""
    from ksql_tpu_torch.common import types as PT

    C = pex.ColumnRef
    op = pex.CompareOp

    def lit(v):
        if isinstance(v, str):
            return pex.StringLiteral(v)
        return pex.IntegerLiteral(v) if -(1 << 31) <= v < (1 << 31) else pex.LongLiteral(v)

    def cmp(o, a, b):
        return pex.Comparison(op[o], a, b)

    def both(a, b, how="AND"):
        return pex.LogicalBinary(pex.LogicOp[how], a, b)

    return {
        "url_and_time": lambda i: both(cmp("EQ", C("URL"), lit(f"/page/{i % 40}")),
                                       cmp("GTE", C("VIEWTIME"), lit(TS0 + 17 * 8 * i))),
        "range": lambda i: both(cmp("GT", C("USER_ID"), lit(i)), cmp("LTE", C("USER_ID"), lit(i + 300))),
        "not": lambda i: pex.Not(cmp("LT", C("VIEWTIME"), lit(TS0 + 17 * 16 * i))),
        "null_or": lambda i: both(pex.IsNull(C("USER_ID")), cmp("EQ", C("URL"), lit(f"/page/{i}")), "OR"),
        "neq": lambda i: cmp("NEQ", C("URL"), lit(f"/page/{i % 8}")),
        "between": lambda i: pex.Between(C("USER_ID"), lit(i), lit(i + 99)),
        "not_between": lambda i: pex.Between(C("USER_ID"), lit(i), lit(i + 899), negated=True),
        "in": lambda i: pex.InList(C("USER_ID"), (lit(i), lit(i + 1), lit(999 - i))),
        "not_in": lambda i: pex.InList(C("USER_ID"), (lit(i), lit(2 * i)), negated=True),
        "div": lambda i: cmp("GT", pex.ArithmeticBinary(pex.ArithOp.DIVIDE, C("VIEWTIME"), C("USER_ID")),
                             lit(TS0 // (i + 1))),
        # CAST: a double truncated to INT, a BIGINT to DECIMAL(4, 1) (NULL
        # past its precision), a TIMESTAMP floored to its DATE
        "cast": lambda i: both(both(
            cmp("GT", pex.Cast(pex.ArithmeticBinary(pex.ArithOp.MULTIPLY, pex.Cast(C("USER_ID"), PT.DOUBLE),
                                                    pex.DoubleLiteral(1.5)), PT.INTEGER), lit(i)),
            cmp("LT", pex.Cast(C("USER_ID"), PT.SqlType.decimal(4, 1)), lit(900 - i))),
            cmp("GTE", pex.Cast(pex.Cast(C("VIEWTIME"), PT.TIMESTAMP), PT.DATE),
                pex.Cast(lit(TS0 // 86_400_000 - (i % 2)), PT.DATE))),
        # CASE: searched with and without ELSE over mixed numeric results
        "case": lambda i: both(
            cmp("GT", pex.SearchedCase((pex.WhenClause(cmp("EQ", C("URL"), lit(f"/page/{i}")), lit(5000)),
                                        pex.WhenClause(pex.IsNull(C("USER_ID")), lit(-1))),
                                       C("USER_ID")), lit(3 * i)),
            pex.Not(cmp("EQ", pex.SearchedCase((pex.WhenClause(cmp("GT", C("USER_ID"), lit(i)),
                                                               pex.DoubleLiteral(0.5)),), None),
                        pex.DoubleLiteral(0.5))), "OR"),
    }


def predicate_plans(pred, lanes):
    """``lanes`` port plans of the mod template with its filter's predicate
    replaced by ``pred(i)`` for lane i."""
    from ksql_tpu_torch.execution.steps import plan_from_json

    base = plan_from_json(tap_template("mod", "page_views"))
    sel = base.physical_plan
    return [dataclasses.replace(base, physical_plan=dataclasses.replace(
        sel, source=dataclasses.replace(sel.source, predicate=pred(i)))) for i in range(lanes)]


def corpus_plans(lanes=TAP_CORPUS_LANES):
    """2p's corpus families: per family ``lanes`` port plans."""
    from ksql_tpu_torch.execution import expressions as pex

    return {name: predicate_plans(pred, lanes) for name, pred in _corpus_predicates(pex).items()}


def mod_plans(lanes):
    """The ``USER_ID % lanes = i`` family (the bench's tap, the template's
    predicate with its modulus set to ``lanes``)."""
    from ksql_tpu_torch.execution import expressions as pex

    return predicate_plans(lambda i: pex.Comparison(pex.CompareOp.EQ, pex.ArithmeticBinary(
        pex.ArithOp.MODULUS, pex.ColumnRef("USER_ID"), pex.IntegerLiteral(lanes)),
        pex.IntegerLiteral(i)), lanes)


def tap_group(torch, plans, lanes):
    """A K25 family of ``lanes`` lanes from port plans of one structure (the
    first ``lanes`` of them, cycled), as the registry packs it; returns the
    family (``server.tap_kernel._LaneGroup``)."""
    from ksql_tpu_torch.execution.steps import plan_from_json
    from ksql_tpu_torch.server import push_registry as preg
    from ksql_tpu_torch.server import tap_kernel as tk

    group = None
    for k in range(lanes):
        p = plans[k % len(plans)]
        chain = preg.residual_chain(p if not isinstance(p, dict) else plan_from_json(p))
        spec = tk.classify_residual(chain[:-1], chain[-1].schema)
        if group is None:
            types = tk._col_types(spec.col_names, {c.name: c.type for c in chain[-1].schema.columns()})
            group = tk._LaneGroup(spec, types, lanes)
        require(spec.signature == group.signature, "tap_group: one family")
        require(group.add(f"t{k}", spec), "tap_group: a lane")
    return group


def make_tap_case(torch, rng, dev, group, rows):
    """K25's arguments for ``group`` over ``rows`` PAGE_VIEWS rows (2% of
    them null rows, the last 1% padding), 3% of the lanes inactive, a
    tenth with a LIMIT budget of 0-50."""
    from ksql_tpu_torch.common.batch import stable_hash64

    lanes = group.capacity
    urls, uid, vt = _pv_columns(rng, rows)
    host = {
        "URL": (np.array([0 if u is None else stable_hash64(u) for u in urls], np.int64),
                np.array([u is not None for u in urls])),
        "USER_ID": (np.array([0 if u is None else u for u in uid], np.int64),
                    np.array([u is not None for u in uid])),
        "VIEWTIME": (np.array([0 if v is None else v for v in vt], np.int64),
                     np.array([v is not None for v in vt])),
        "ROWTIME": (TS0 + 17 * np.arange(rows, dtype=np.int64), np.ones(rows, bool)),
    }
    datas = [torch.from_numpy(host[c][0]).to(dev) for c in group.rep.col_names]
    valids = [torch.from_numpy(host[c][1]).to(dev) for c in group.rep.col_names]
    row_valid = rng.random(rows) >= 0.02
    row_valid[rows - rows // 100:] = False
    for k in np.nonzero(rng.random(lanes) < 0.03)[0]:
        group.remove(f"t{k}")
    limits = np.where(rng.random(lanes) < 0.1, rng.integers(0, 51, lanes), 1 << 62).astype(np.int64)
    P_i, P_f, active = group.device_params(dev)
    return (datas, valids, P_i, P_f, active, torch.from_numpy(row_valid).to(dev),
            torch.from_numpy(limits).to(dev))


def _tap_bytes_ops(prog, args):
    """K25's bytes and operations: each column that the program loads, its
    data and validity, and each parameter that it reads, once; row_valid;
    per lane its active flag and limit read and its count written; the
    masks written; one operation per instruction, lane and row."""
    from ksql_tpu_torch.ops.tap_residual import OP_COL, OP_PARAM_F, OP_PARAM_I

    datas, valids, P_i, P_f, active, row_valid, limits = args
    lanes, rows = P_i.shape[0], datas[0].shape[0]
    read = {op: {int(a) for o, a, _, _ in prog.code if o == op} for op in (OP_COL, OP_PARAM_I, OP_PARAM_F)}
    col = sum(datas[c].element_size() * rows + rows for c in read[OP_COL])
    params = 8 * (len(read[OP_PARAM_I]) + len(read[OP_PARAM_F]))
    per_lane = params + 1 + 8 + 8  # params, active, limit, count
    return col + rows + lanes * per_lane + lanes * rows, lanes * rows * prog.n_instr


def _check_tap(torch, tr, group, args, tag):
    prog = group.program()
    before = tr.lane_masks.launches
    got = tr.lane_masks(prog, *args)
    require(tr.lane_masks.launches == before + 1, f"{tag}: K25 counted no launch")
    want = tr.lane_masks_plain(prog.spec, prog.col_types, *args)
    _assert_equal(torch, f"{tag}.masks", got[0], want[0])
    _assert_equal(torch, f"{tag}.counts", got[1], want[1])
    return prog, int(want[1].sum())


def phase_tap_kernels(torch, seed):
    """Phase 2p: K25 against its twin on the card, exact.  Returns ``{shape:
    record}``."""
    from ksql_tpu_torch.ops import tap_residual as tr

    dev = torch.device(DEVICE)
    rng = np.random.default_rng(seed + 60)
    recs = {}
    for lanes, rows in ((TAP_LANES, TAP_ROWS), (TAP_MAX_LANES, TAP_MAX_ROWS)):
        group = tap_group(torch, mod_plans(lanes), lanes)
        args = make_tap_case(torch, rng, dev, group, rows)
        prog, matched = _check_tap(torch, tr, group, args, f"tap_residual[{lanes}x{rows}]")
        require(matched > 0, f"2p: no row matched at {lanes} x {rows}")
        nbytes, ops = _tap_bytes_ops(prog, args)
        # one kernel record a call (no memset, no second launch)
        rec = measure(torch, "tap_residual", lambda: tr.lane_masks(prog, *args),
                      lambda: tr.lane_masks_plain(prog.spec, prog.col_types, *args), nbytes, ops,
                      per_call=1)
        rec.update(max_abs_err=0.0, lanes=lanes, rows=rows, matched=matched, n_instr=prog.n_instr)
        recs[f"{lanes}x{rows}"] = rec
        _report("2p", f"tap_residual[{lanes} lanes x {rows} rows, {prog.n_instr} instructions, "
                f"{matched} matches]", rec)
    for name, plans in corpus_plans().items():
        group = tap_group(torch, plans, TAP_CORPUS_LANES)
        args = make_tap_case(torch, rng, dev, group, TAP_ROWS)
        prog, matched = _check_tap(torch, tr, group, args, f"tap_residual[{name}]")
        print(f"[2p] tap_residual[{name}] ({TAP_CORPUS_LANES} lanes x {TAP_ROWS} rows, {prog.n_instr} "
              f"instructions, stack {prog.max_depth}): exact, {matched} matches")
    return recs


def fanout_traffic(seed, n):
    """Phases 20 and 21's events: bench_push_fanout's payload (bench.py:
    940-944, USER_ID 1 + i % 999, VIEWTIME 17 ms apart) with bench.py:119-
    146's zipf(1.3) URLs and 5% NULL USER_IDs."""
    rng = np.random.default_rng(seed + 70)
    url = rng.zipf(1.3, size=n).astype(np.int64) % N_URLS
    uid = [None if rng.random() < TAP_NULLS else 1 + i % 999 for i in range(n)]
    vt = TS0 + 17 * np.arange(n, dtype=np.int64)
    return [f"/page/{k}" for k in url], uid, [int(v) for v in vt]


def fanout_taps(n):
    """Phase 20's taps: (kind, template values, LIMIT, model row filter,
    projected columns)."""
    taps = [("mod", {0: i}, None, (lambda i: lambda u, d, v: d is not None and d % 256 == i)(i),
             ("URL", "VIEWTIME")) for i in range(TAP_LANES)]
    for k in range(FANOUT_URL_TAPS):
        t = TS0 + 17 * (k * n // (2 * FANOUT_URL_TAPS))
        taps.append(("url", {"/page/0": f"/page/{k}", 0: t}, None,
                     (lambda k, t: lambda u, d, v: u == f"/page/{k}" and v >= t)(k, t), ("URL", "USER_ID")))
    for i in range(FANOUT_LIMIT_TAPS):
        taps.append(("mod", {0: i + 1}, FANOUT_LIMIT,
                     (lambda i: lambda u, d, v: d is not None and d % 256 == i)(i + 1), ("URL", "VIEWTIME")))
    taps.append(("like", {}, None, lambda u, d, v: u.startswith("/page/1"), ("URL", "USER_ID")))
    return taps


def fanout_model(taps, urls, uids, vts):
    out = []
    for _kind, _vals, limit, keep, cols in taps:
        rows = []
        for u, d, v in zip(urls, uids, vts):
            if keep(u, d, v):
                row = {"URL": u, "USER_ID": d, "VIEWTIME": v}
                rows.append({c: row[c] for c in cols})
        out.append(rows[:limit] if limit is not None else rows)
    return out


def run_fanout(torch, source, n, round_size, device, seed, upstream=None):
    """Open phase 20's taps over ``source`` (PAGE_VIEWS, or PV_STREAM from
    the upstream plan run at ``round_size``), produce ``n`` events in
    rounds of ``round_size``, polling every session after each round, then
    until quiet.  Returns (sessions, taps, registry, stats)."""
    from ksql_tpu_torch.runner import start_plan, start_push_registry
    from ksql_tpu_torch.runtime.topics import Broker, Record
    from ksql_tpu_torch.server.push_session import PushQuerySession

    broker = Broker()
    broker.create_topic("page_views")
    reg = start_push_registry(broker, device=device)
    if upstream is not None:
        h = start_plan(upstream, broker, device=device, capacity=round_size)
        reg.register_upstream("PV_STREAM", h)
    urls, uids, vts = fanout_traffic(seed, n)
    taps = fanout_taps(n)
    templates = {k: tap_template(k, source) for k in ("mod", "url", "like")}
    sessions = [PushQuerySession(reg, tap_plan(templates[kind], vals), limit)
                for kind, vals, limit, _keep, _cols in taps]
    topic = broker.topic("page_views")
    rounds = []
    t0 = time.perf_counter()
    for lo in range(0, n, round_size):
        for i in range(lo, min(n, lo + round_size)):
            topic.produce(Record(key=None, value=json.dumps(
                {"URL": urls[i], "USER_ID": uids[i], "VIEWTIME": vts[i]}), timestamp=vts[i]))
        t1 = time.perf_counter()
        for s in sessions:
            s.poll()
        rounds.append(time.perf_counter() - t1)
    while sum(len(s.poll()) for s in sessions):
        pass
    secs = time.perf_counter() - t0
    want = fanout_model(taps, urls, uids, vts)
    for k, (s, w) in enumerate(zip(sessions, want)):
        got = [r for r in s.rows if "__gap__" not in r]
        require(len(got) == len(s.rows), f"{source}: session {k} took a gap marker")
        require(got == w, f"{source}: session {k} ({taps[k][0]} {taps[k][1]}) delivered {len(got)} rows, "
                f"the numpy model {len(w)}")
    delivered = sum(len(s.rows) for s in sessions)
    p50, p99 = np.percentile(np.array(rounds) * 1e3, [50, 99])
    return sessions, taps, reg, dict(rows_per_s=delivered / secs, delivered=delivered, seconds=secs,
                                     round_p50_ms=p50, round_p99_ms=p99, rounds=len(rounds))


def _check_fanout(tag, sessions, reg):
    pipe = next(iter(reg.pipelines.values()))
    kernel = pipe.kernel
    fused = [s.tap for s in sessions if s.tap.fused]
    require(len(fused) == len(sessions) - 1, f"{tag}: {len(fused)} fused taps of {len(sessions)}")
    for tap in fused:
        require(tap.fused_spans > 0 and tap.host_spans == 0,
                f"{tag}: fused tap {tap.id} had {tap.fused_spans} K25 spans, {tap.host_spans} host spans")
    require(reg.stats()["residual"]["host-taps"] == 1, f"{tag}: the LIKE tap is not on the host")
    return pipe, kernel


def phase_push_fanout(torch, seed, n=FANOUT_EVENTS):
    """Phase 20: the standalone fan-out on the card, its launches on this
    path counted; then the port's CPU run of the same."""
    from ksql_tpu_torch.ops import tap_residual as tr

    zero_launches()
    sessions, taps, reg, stats = run_fanout(torch, "page_views", n, FANOUT_ROUND, DEVICE, seed)
    PATH_LAUNCHES["20"] = read_launches()
    check_path_launches("20", PATH_LAUNCHES["20"])
    pipe, kernel = _check_fanout("20", sessions, reg)
    launches = PATH_LAUNCHES["20"]["tap_residual"]["all"]
    require(launches == kernel.evaluations * len(kernel.groups),
            f"20: {launches} K25 launches for {kernel.evaluations} spans of {len(kernel.groups)} families")
    require(pipe.mode == "standalone" and pipe.executor.query.capacity == 1, "20: not per record")
    cpu_sessions, _, _, cpu_stats = run_fanout(torch, "page_views", n, FANOUT_ROUND, "cpu", seed)
    require([s.rows for s in sessions] == [s.rows for s in cpu_sessions], "20: card rows differ from the CPU run")
    print(f"[20] standalone fan-out: {len(sessions)} sessions ({sum(s.tap.fused for s in sessions)} fused in "
          f"{len(kernel.groups)} families), {n} events in {stats['rounds']} rounds of {FANOUT_ROUND}: "
          f"{stats['delivered']} rows delivered in {stats['seconds']:.3f} s = {stats['rows_per_s']:.1f} rows/s; "
          f"poll round p50 {stats['round_p50_ms']:.3f} ms p99 {stats['round_p99_ms']:.3f} ms; K25 launches "
          f"{launches} over {kernel.evaluations} spans; every session equals the numpy model and the CPU run "
          f"({cpu_stats['seconds']:.3f} s)")
    return dict(stats, k25_launches=launches, spans=kernel.evaluations, cpu_seconds=cpu_stats["seconds"])


def phase_push_listener(torch, seed, rounds=LISTENER_ROUNDS):
    """Phase 21: the listener fan-out over PV_STREAM on the card, then the
    port's CPU run of the same."""
    with open(PV_STREAM_PLAN) as f:
        upstream = json.load(f)
    n = rounds * LISTENER_ROUND
    zero_launches()
    sessions, taps, reg, stats = run_fanout(torch, "pv_stream", n, LISTENER_ROUND, DEVICE, seed,
                                            upstream=upstream)
    PATH_LAUNCHES["21"] = read_launches()
    check_path_launches("21", PATH_LAUNCHES["21"])
    pipe, kernel = _check_fanout("21", sessions, reg)
    require(pipe.mode == "listener", "21: the pipeline is not a listener")
    require(kernel.block_spans == kernel.evaluations > 0,
            f"21: {kernel.block_spans} of {kernel.evaluations} spans came from device emit blocks")
    launches = PATH_LAUNCHES["21"]["tap_residual"]["all"]
    cpu_sessions, _, _, cpu_stats = run_fanout(torch, "pv_stream", n, LISTENER_ROUND, "cpu", seed,
                                               upstream=upstream)
    require([s.rows for s in sessions] == [s.rows for s in cpu_sessions], "21: card rows differ from the CPU run")
    print(f"[21] listener fan-out over PV_STREAM: {len(sessions)} sessions, {n} records in {rounds} rounds of "
          f"{LISTENER_ROUND}: {stats['delivered']} rows delivered in {stats['seconds']:.3f} s = "
          f"{stats['rows_per_s']:.1f} rows/s; poll round p50 {stats['round_p50_ms']:.3f} ms p99 "
          f"{stats['round_p99_ms']:.3f} ms; K25 launches {launches} over {kernel.evaluations} spans, "
          f"{kernel.block_spans} from device blocks; every session equals the numpy model and the CPU run "
          f"({cpu_stats['seconds']:.3f} s)")
    return dict(stats, k25_launches=launches, spans=kernel.evaluations, block_spans=kernel.block_spans,
                cpu_seconds=cpu_stats["seconds"])


# ---------------------------------------- phases 2a, 22-23s (B3 argset)
ARGSET_FILL = 0.7  # phase 2a's store: 70% of the slots hold a window, with graves
ARGSET_NEVER = 0.1  # of the held slots, the share that never had a candidate (init order)
RIDER_ROWS = 1 << 16  # phase 22: 8 x 65,536 location records
RIDER_BATCHES = 8
RIDER_PROFILES = 300_000  # uniform profile ids: 0.29 load of 2^20 slots
RIDER_NULLS = 0.02  # the share of NULL latitudes
OFFSET_NULLS = 0.02  # phases 23-23s: the share of NULL USER_IDs
OFFSET_BATCHES = 8  # phase 23: the flagship's 8 x 65,536
OFFSET_HOP_BATCHES = 8  # phase 23h: phase 8's 8 x 16,384, k = 4
OFFSET_SESS_BATCHES = 4  # phase 23s: 4 x 8,192 (phase 11's batch, half its depth)
CURRENT_LOCATION_PLAN = os.path.join(_PLANS, "current_location.json")
OFFSETS_PLAN = os.path.join(_PLANS, "pv_offsets.json")
OFFSETS_HOP_PLAN = os.path.join(_PLANS, "pv_offsets_hopping.json")
OFFSETS_SESS_PLAN = os.path.join(_PLANS, "pv_offsets_session.json")
I64_MIN, I64_MAX = -(1 << 63), (1 << 63) - 1


def argset_components(hs):
    """The offset aggregates' store components (ops/device_aggs.py): the ts
    watermark, then EARLIEST (int64 min order, a float64 value and its
    valid bit) and LATEST (int64 max order, an int64 value, its valid bit)."""
    A = hs.AggComponent
    return (A("max", "int64", I64_MIN), A("min", "int64", I64_MAX), A("argset", "float64", 0),
            A("argset", "int32", 0), A("max", "int64", I64_MIN), A("argset", "int64", 0),
            A("argset", "int32", 0))


def _payload_doubles(rng, n):
    v = rng.normal(0, 100, n)
    sp = np.array([-0.0, 0.0, np.nan, -np.nan, np.inf])
    pick = rng.random(n) < 0.1
    v[pick] = sp[rng.integers(0, sp.size, int(pick.sum()))]
    return v


def make_argset_case(torch, hs, rng, dev, n=N_ROWS, capacity=STORE):
    """Phase 2a's K3 case, after K3's fold settled the orders: a store of
    ``capacity`` slots, 70% of them holding a window (5% graves; a tenth of
    the held slots never had a candidate, so their orders are the init),
    the others' orders sequence numbers of earlier batches and their
    payloads set; a batch of ``n`` rows whose sequence numbers continue
    them, zipf(1.3) over the held slots, 3% inactive (aimed at the dump,
    identity contributions), 1% active but overflowed (the dump), and
    NULL values where EARLIEST ignores them and LATEST(x, false) does not
    (a row there is no candidate, or a candidate with a NULL payload);
    float payloads with -0.0, +0.0, NaN and inf.  Returns (store, scratch,
    layout, slots, contribs) on ``dev``."""
    comps = argset_components(hs)
    layout = hs.StoreLayout(capacity=capacity, num_keys=1, components=comps, windowed=True)
    st = hs.init_store(layout, "cpu")
    held = np.nonzero(rng.random(capacity) < ARGSET_FILL)[0]
    st["occ"][torch.from_numpy(held)] = True
    graves = np.nonzero(rng.random(capacity) < 0.05)[0]
    graves = graves[~np.isin(graves, held)]
    st["grave"][torch.from_numpy(graves)] = True
    seq0 = 1 << 40
    seen = held[rng.random(held.size) >= ARGSET_NEVER]
    old = rng.choice(seq0, 2 * seen.size, replace=False)
    for j, vals in ((1, old[: seen.size]), (4, old[seen.size:])):
        st[f"a{j}"][torch.from_numpy(seen)] = torch.from_numpy(vals.astype(np.int64))
    st["a2"][torch.from_numpy(seen)] = torch.from_numpy(_payload_doubles(rng, seen.size))
    st["a3"][torch.from_numpy(seen)] = torch.from_numpy((rng.random(seen.size) < 0.9).astype(np.int32))
    st["a5"][torch.from_numpy(seen)] = torch.from_numpy(rng.integers(-10**12, 10**12, seen.size))
    st["a6"][torch.from_numpy(seen)] = torch.from_numpy((rng.random(seen.size) < 0.9).astype(np.int32))
    slots = held[(rng.zipf(1.3, n) - 1) % held.size].astype(np.int32)
    active = rng.random(n) >= 0.03
    slots[~active] = capacity
    slots[rng.random(n) < 0.01] = capacity  # overflowed: active, at the dump
    seq = seq0 + np.arange(n, dtype=np.int64)
    valid = rng.random(n) >= 0.1
    e_cand = active & valid  # EARLIEST ignores NULLs
    l_cand = active.copy()  # LATEST(x, false) takes them
    x = _payload_doubles(rng, n)
    y = rng.integers(-10**12, 10**12, n)
    contribs = [
        np.where(active, TS0 + np.arange(n), I64_MIN).astype(np.int64),
        np.where(e_cand, seq, I64_MAX), np.where(e_cand, x, 0.0), (e_cand & valid).astype(np.int32),
        np.where(l_cand, seq, I64_MIN), np.where(l_cand, y, 0), (l_cand & valid).astype(np.int32),
    ]
    contribs = [torch.from_numpy(c) for c in contribs]
    slots_t = torch.from_numpy(slots)
    hs.fold_and_mark_plain(st, layout, slots_t, contribs, torch.from_numpy(active))
    store = {k: v.to(dev) for k, v in st.items()}
    return (store, hs.init_scratch(capacity, dev), layout, slots_t.to(dev),
            [c.to(dev) for c in contribs])


def argset_bytes(slots, contribs, layout, hs, winners):
    """K3 argset's bytes: per row its slot, each order component's
    contribution and the order cell at its slot, and each payload's
    contribution, all read once; per winning (row, payload) the payload
    written (``winners``: payload component -> winning rows); the dump
    cell of each payload written once."""
    n = slots.shape[0]
    pairs = hs.argset_pairs(layout)
    total = 4 * n
    for o in sorted({o for _j, o in pairs}):
        total += 2 * n * contribs[o].element_size()
    for j, _o in pairs:
        total += (n + winners[j] + 1) * contribs[j].element_size()
    return total


def make_merge_case(torch, sess, hs, rng, dev, n=SESS_ROWS, slots=SESS_2W_SLOTS, keys=N_URLS, ties=False):
    """Phase 2a's K15 case at phase 2w's shapes, in K14's item layout: n rows
    of zipf(1.3) keys over 50,000 URLs, 17 ms apart, 3% inactive (dead),
    then the S stored-session items of each row, alive for a key's first
    row where a session was stored (half of them), starts up to 30 s
    gaps apart, the other store items dead (key ``SENTINEL + index``, start
    and end 0, as K14 leaves them).  The offsets' components: orders are
    unique sequence numbers (a tenth of the items no candidate: the
    init), payloads with -0.0, +0.0, NaN and inf; ``ties`` takes the orders
    modulo 50, so a segment's alive items tie on its order and its payload
    is their sum.  Returns (items, perm, components) on ``dev``."""
    comps = argset_components(hs)
    m = n * (slots + 1)
    row_kh = (rng.zipf(1.3, n) % keys).astype(np.int64) * 7919 + 11
    first = np.zeros(n, bool)
    first[np.unique(row_kh, return_index=True)[1]] = True
    kh = np.concatenate([row_kh, np.tile(row_kh, slots)])
    start = np.concatenate([TS0 + np.arange(n, dtype=np.int64) * SESS_STEP_MS,
                            TS0 - rng.integers(1, 40, n * slots) * SESS_GAP_MS])
    end = start + rng.integers(0, SESS_GAP_MS, m)
    end[:n] = start[:n]
    alive = np.concatenate([rng.random(n) >= 0.03, np.tile(first, slots) & (rng.random(n * slots) < 0.5)])
    dead = np.nonzero(~alive)[0]
    kh[dead] = sess.SENTINEL + dead
    start[dead] = 0
    end[dead] = 0
    seqs = rng.permutation(m * 4)[:m].astype(np.int64)
    if ties:
        seqs %= 50
    nocand = rng.random(m) < 0.1
    cols = [
        end.copy(), np.where(nocand, I64_MAX, seqs), _payload_doubles(rng, m),
        (rng.random(m) < 0.9).astype(np.int32), np.where(nocand, I64_MIN, seqs[::-1].copy()),
        rng.integers(-10**12, 10**12, m), (rng.random(m) < 0.9).astype(np.int32),
    ]
    items = {
        "kh": torch.from_numpy(kh).to(dev), "start": torch.from_numpy(start).to(dev),
        "end": torch.from_numpy(end).to(dev), "alive": torch.from_numpy(alive).to(dev),
        "slot": torch.from_numpy(rng.integers(0, SESS_STORE + 1, m).astype(np.int32)).to(dev),
        "reprs": torch.from_numpy(row_kh[np.arange(m) % n][None, :].copy()).to(dev),
        "comps": [torch.from_numpy(c).to(dev) for c in cols],
    }
    perm = sess.seg_sort_plain(items["kh"].cpu(), items["start"].cpu()).to(dev)
    return items, perm, comps


def merge_bytes(m, nseg, k, cb):
    """K15's bytes over ``m`` items in ``nseg`` segments, ``k`` key columns
    and ``cb`` component bytes an item: the permutation and each item
    column read once, the sorted items and their per-item outputs written
    once, the segment columns written once per segment, the overflow
    count once."""
    return m * (4 + 29 + 8 * k + cb) + m * (30 + 8 * k + cb + 19 + 8 * k) + nseg * (26 + 8 * k + cb) + 8


def longest_run(torch, sess, kh):
    """The longest run of equal key hashes among K15's sorted items ``kh``:
    its length and the number of K15's tiles (``sess.MERGE_TILE`` sorted
    positions) it touches, the serial part of K15's merge launch (None for
    a package without tiles)."""
    _keys, lens = torch.unique_consecutive(kh, return_counts=True)
    heads = torch.cumsum(lens, 0) - lens
    i = int(lens.argmax())
    length, head = int(lens[i]), int(heads[i])
    tile = getattr(sess, "MERGE_TILE", None)  # None: a tree whose K15 has no tiles
    return length, None if tile is None else (head % tile + length + tile - 1) // tile


def check_merge_argset(torch, sess, items, perm, comps, n, slots, capacity, what):
    """K15's argset mode launched once (and counted) on the items, held to
    its twin by the bits: every sorted item column, and every segment
    value read through segfirst.  Returns the twin's outputs."""
    before = sess.session_merge.mode_launches["argset"]
    got = sess.session_merge(items, perm, n, slots, SESS_GAP_MS, comps, capacity)
    require(sess.session_merge.mode_launches["argset"] == before + 1, f"{what} counted no launch")
    want = sess.session_merge_plain(items, perm, n, slots, SESS_GAP_MS, comps, capacity)

    def bits(x):
        return x.view(torch.int64) if x.dtype == torch.float64 else x

    sf = want["segfirst"].long()
    for keys, pick in ((sess.MERGE_ITEM_KEYS + ("sess_ovf",), lambda x: x),
                       (sess.MERGE_SEG_KEYS, lambda x: x[..., sf])):
        for key in keys:
            g, w = got[key], want[key]
            for a, b in (zip(g, w) if isinstance(g, list) else ((g, w),)):
                _assert_equal(torch, f"session_merge[argset].{key}", bits(pick(a)), bits(pick(b)))
    return want


def phase_argset_kernels(torch, seed):
    """Phase 2a: K3's argset mode at the flagship's shapes and K15's argset
    mode at 2w's, exact against their twins (every component, the dump
    slot included; K15's sorted items and its segment values through
    segfirst, also over tied orders).  Returns ``{kernel: {"argset": record}}``."""
    from ksql_tpu_torch.ops import hash_store as hs
    from ksql_tpu_torch.ops import session as sess

    t0 = time.perf_counter()
    dev = torch.device(DEVICE)
    rng = np.random.default_rng(seed + 70)
    store, scratch, layout, slots, contribs = make_argset_case(torch, hs, rng, dev)
    base = _clone(store)
    want = _clone(store)
    hs.fold_argset_plain(want, layout, slots, contribs)
    before = hs.fold_and_mark.mode_launches["argset"]
    hs.fold_argset(store, scratch, layout, slots, contribs)
    require(hs.fold_and_mark.mode_launches["argset"] == before + 1, "2a: K3 argset counted no launch")
    err = max(_assert_equal(torch, f"fold_and_mark[argset].{k}", store[k].view(torch.int64)
                            if store[k].dtype == torch.float64 else store[k],
                            want[k].view(torch.int64) if want[k].dtype == torch.float64 else want[k])
              for k in store)
    require(int((scratch["dump_row"] != -1).sum()) == 0 and int(scratch["ticket"][0]) == 0,
            "2a: K3 argset left a dump cell or its done count set")
    n = slots.shape[0]
    cap = layout.capacity
    per_payload = {j: int(((slots != cap) & (contribs[o] == want[f"a{o}"][slots.long()])).sum())
                   for j, o in hs.argset_pairs(layout)}
    winners = sum(per_payload.values())
    lib_slots = torch.where(slots == cap, torch.zeros_like(slots), slots).long()
    rec = measure(torch, "fold_and_mark", lambda: hs.fold_argset(store, scratch, layout, slots, contribs),
                  lambda: hs.fold_argset_plain(store, layout, slots, contribs),
                  argset_bytes(slots, contribs, layout, hs, per_payload), 0,
                  reset=lambda: _restore(store, base),
                  library=lambda: [store[f"a{j}"].index_put_((lib_slots,), contribs[j].to(store[f"a{j}"].dtype))
                                   for j, _o in hs.argset_pairs(layout)])
    rec.update(max_abs_err=err, rows=n, winners=winners)
    _report("2a", f"fold_and_mark[argset] ({n} rows into {cap} + 1 slots, {winners} winning (row, "
            "component) pairs; yardstick index_put_, whose duplicate order is unspecified, so it "
            "cannot keep the dump rule)", rec)
    out = {"fold_and_mark": {"argset": rec}}
    for ties in (True, False):  # the case with ties is checked, the other also timed
        items, perm, comps = make_merge_case(torch, sess, hs, rng, dev, ties=ties)
        want = check_merge_argset(torch, sess, items, perm, comps, SESS_ROWS, SESS_2W_SLOTS, SESS_STORE,
                                  "2a: K15 argset" + (" with tied orders" if ties else ""))
    m = perm.shape[0]
    segs = int(want["winner"].sum())
    nseg = int((want["segfirst"] == torch.arange(m, device=dev, dtype=torch.int32)).sum())
    cb = sum(c.element_size() for c in items["comps"])
    rec = measure(torch, "session_merge",
                  lambda: sess.session_merge(items, perm, SESS_ROWS, SESS_2W_SLOTS, SESS_GAP_MS, comps,
                                             SESS_STORE),
                  lambda: sess.session_merge_plain(items, perm, SESS_ROWS, SESS_2W_SLOTS, SESS_GAP_MS,
                                                   comps, SESS_STORE),
                  merge_bytes(m, nseg, items["reprs"].shape[0], cb), 0, plain_reps=3)
    run, tiles = longest_run(torch, sess, want["kh"])
    rec.update(max_abs_err=0.0, items=m, segments=segs, longest_run=run, longest_run_tiles=tiles)
    _report("2a", f"session_merge[argset] ({m} items, {segs} segments, 7 components, longest key run "
            f"{run} items over {tiles} tiles of {sess.MERGE_TILE}; no single PyTorch call computes it)",
            rec)
    out["session_merge"] = {"argset": rec}
    print(f"[2a] seconds {time.perf_counter() - t0:.1f}")
    return out


def rider_traffic(seed, n_batches=RIDER_BATCHES, rows=RIDER_ROWS):
    """Phase 22's records: profile ids uniform over RIDER_PROFILES, 2% NULL
    latitudes, latitudes and longitudes uniform, 17 ms apart."""
    rng = np.random.default_rng(seed + 80)
    n = n_batches * rows
    pid = rng.integers(0, RIDER_PROFILES, n)
    lat = np.round(rng.uniform(-90, 90, n), 6)
    lon = np.round(rng.uniform(-180, 180, n), 6)
    null = rng.random(n) < RIDER_NULLS
    return pid, lat, lon, null, TS0 + np.arange(n, dtype=np.int64) * 17


def produce_riders(broker, pid, lat, lon, null, ts):
    from ksql_tpu_torch.runtime.topics import Record

    topic = broker.create_topic("locations")
    for p, a, o, z, t in zip(pid.tolist(), lat.tolist(), lon.tolist(), null.tolist(), ts.tolist()):
        la = "null" if z else repr(a)
        topic.produce(Record(key=None, value=f'{{"PROFILEID":"p{p}","LATITUDE":{la},"LONGITUDE":{o!r}}}',
                             timestamp=t))


def _run_offsets(torch, plan_json, produce, device, rows, store, batch_s=None, path=None, **kw):
    """``run_plan`` over freshly produced records (``produce(broker)``);
    launches zeroed before and read after when ``path`` is given."""
    from ksql_tpu_torch.runner import run_plan
    from ksql_tpu_torch.runtime.topics import Broker

    broker = Broker()
    produce(broker)
    undo = _timed_batches(torch, batch_s) if batch_s is not None else (lambda: None)
    try:
        if path is not None:
            zero_launches()
        t0 = time.perf_counter()
        ex = run_plan(plan_json, broker, device=device, capacity=rows, store_capacity=store, **kw)
        if device != "cpu":
            torch.cuda.synchronize()
        secs = time.perf_counter() - t0
    finally:
        undo()
    if path is not None:
        PATH_LAUNCHES[path] = read_launches()
        check_path_launches(path, PATH_LAUNCHES[path])
    return broker, ex, secs


def _offsets_e2e(torch, plan_json, produce, topic, n, rows, store, tag, **kw):
    """One offsets plan on the card (launches held to ``PATH_KERNELS[tag]``)
    and on the CPU: the sinks must be equal, nothing may overflow."""
    torch.cuda.reset_peak_memory_stats()
    batch_s = []
    broker, ex, secs = _run_offsets(torch, plan_json, produce, DEVICE, rows, store, batch_s, tag, **kw)
    peak = torch.cuda.max_memory_allocated()
    q = ex.query
    require(int(q.state["overflow"]) == 0, f"{tag}: store overflowed")
    require(int(q.state["agg_seq"]) > 0, f"{tag}: the arrival sequence did not advance")
    cpu_broker, _ex, cpu_secs = _run_offsets(torch, plan_json, produce, "cpu", rows, store, **kw)
    sink = sink_records(broker, topic)
    require(sink == sink_records(cpu_broker, topic), f"{tag}: card sink differs from the CPU run")
    p50, p99 = np.percentile(np.array(batch_s) * 1e3, [50, 99])
    return broker, q, dict(events_per_s=n / secs, p50_ms=p50, p99_ms=p99, peak_bytes=peak,
                           sink_records=len(sink), cpu_s=cpu_secs, store_slots=q.store_capacity,
                           grows=q.grows)


def phase_current_location(torch, plan_json, seed):
    """Phase 22: the ksqlDB quickstart's currentLocation
    (``current_location.json``: LATEST_BY_OFFSET of LATITUDE and LONGITUDE
    per PROFILEID) over 8 x 65,536 records of 300,000 uniform profile ids
    with 2% NULL latitudes into a 2^20-slot store: the sink must equal the
    CPU run record for record, the last LA/LO per profile the last non-NULL
    value in arrival order, no overflow."""
    t0 = time.perf_counter()
    pid, lat, lon, null, ts = rider_traffic(seed)
    n = pid.size
    broker, q, rec = _offsets_e2e(
        torch, plan_json, lambda b: produce_riders(b, pid, lat, lon, null, ts), "CURRENTLOCATION", n,
        RIDER_ROWS, STORE, "22")
    last = {}
    for key, value, _t, _w in sink_records(broker, "CURRENTLOCATION"):
        last[key] = json.loads(value)
    want_la, want_lo = {}, {}
    for p, a, o, z in zip(pid.tolist(), lat.tolist(), lon.tolist(), null.tolist()):
        want_lo[f"p{p}"] = o
        if not z:
            want_la[f"p{p}"] = a
    require(set(last) == set(want_lo), f"22: {len(last)} profiles in the sink, {len(want_lo)} sent")
    bad = sum(1 for k, v in last.items() if v["LA"] != want_la.get(k) or v["LO"] != want_lo[k])
    require(bad == 0, f"22: {bad} profiles' last LA/LO differ from the numpy model")
    print(f"[22] current_location: {n} events in batches of {RIDER_ROWS}, {len(last)} profiles, "
          f"{rec['sink_records']} sink records; {rec['events_per_s']:.1f} events/s; batch p50 "
          f"{rec['p50_ms']:.3f} ms p99 {rec['p99_ms']:.3f} ms; peak device memory {rec['peak_bytes']} B; "
          f"store {q.store_capacity} slots; sink equals the CPU run ({rec['cpu_s']:.3f} s), last "
          f"LA/LO equal the numpy model, overflow 0; seconds {time.perf_counter() - t0:.1f}")
    return dict(rec, profiles=len(last))


def offsets_traffic(seed, n_batches, rows):
    """Phase 6's traffic shape (50,000 URLs zipf(1.3), USER_ID 1..999, 17 ms
    apart) with 2% NULL USER_IDs: (url_idx, uid or -1 for NULL, ts)."""
    rng = np.random.default_rng(seed + 90)
    n = n_batches * rows
    url_idx = rng.zipf(1.3, n).astype(np.int64) % N_URLS
    uid = rng.integers(1, 1000, n)
    uid[rng.random(n) < OFFSET_NULLS] = -1
    return url_idx, uid, TS0 + np.arange(n, dtype=np.int64) * 17


def produce_offsets(broker, url_idx, uid, ts):
    from ksql_tpu_torch.runtime.topics import Record

    topic = broker.create_topic("page_views")
    for u, x, t in zip(url_idx.tolist(), uid.tolist(), ts.tolist()):
        xs = "null" if x < 0 else str(x)
        topic.produce(Record(key=None, value=f'{{"URL":"/page/{u}","USER_ID":{xs},"VIEWTIME":{t}}}',
                             timestamp=t))


def offsets_model(groups):
    """pv_offsets' final values per group from its USER_IDs in arrival
    order (-1 for NULL): the first non-NULL id; the last record's id x 0.1
    (NULLs kept); the ids over 500; max |id - 500| over the non-NULL ids;
    their exact sum."""
    out = {}
    for k, xs in groups.items():
        vals = [x for x in xs if x >= 0]
        out[k] = {"FIRST_USER": vals[0] if vals else None,
                  "LAST_SCORE": None if xs[-1] < 0 else float(xs[-1]) * 0.1,
                  "HIGH_USERS": sum(1 for x in vals if x > 500),
                  "MAX_DIST": max(abs(x - 500) for x in vals) if vals else None,
                  "USER_SUM": sum(vals)}
    return out


def _check_offsets(last, want, tag):
    require(set(last) == set(want), f"{tag}: {len(last)} keys in the sink, {len(want)} in the model")
    bad = 0
    for k, w in want.items():
        g = dict(last[k])
        g["USER_SUM"] = int(round(g["USER_SUM"] * 100))
        if g != dict(w, USER_SUM=100 * w["USER_SUM"]):
            bad += 1
    require(bad == 0, f"{tag}: {bad} keys' final values differ from the numpy model")


def phase_pv_offsets(torch, plans, seed):
    """Phases 23, 23h and 23s: pv_offsets.json (EARLIEST/LATEST_BY_OFFSET,
    a CASE in a SUM, MAX(ABS(...)), a DECIMAL SUM over a CAST, per URL and
    hour) over the flagship's 8 x 65,536 records with 2% NULL USER_IDs;
    its HOPPING variant over phase 8's 8 x 16,384 (the expansion route:
    the offsets do not slice) and its SESSION variant over phase 11's
    batch.  Each sink must equal the CPU run, every final value per (URL,
    window) the numpy model (the DECIMAL sum exactly), nothing overflows."""
    out = {}
    for tag, name, rows, n_batches, store in (("23", "pv_offsets", N_ROWS, OFFSET_BATCHES, STORE),
                                              ("23h", "pv_offsets_hopping", HOP_ROWS, OFFSET_HOP_BATCHES,
                                               STORE),
                                              ("23s", "pv_offsets_session", SESS_ROWS,
                                               OFFSET_SESS_BATCHES, SESS_STORE)):
        t0 = time.perf_counter()
        url_idx, uid, ts = offsets_traffic(seed, n_batches, rows)
        n = url_idx.size
        topic = name.upper()
        kw = {"sliced": None} if tag == "23h" else {}
        if tag == "23s":
            kw["session_slots"] = SESS_SLOTS
        broker, q, rec = _offsets_e2e(torch, plans[name], lambda b: produce_offsets(b, url_idx, uid, ts),
                                      topic, n, rows, store, tag, **kw)
        groups: dict = {}
        if tag == "23s":
            last = {}
            for key, value, _t, w in sink_records(broker, topic):
                if value is None:
                    last.pop((key, w[0], w[1]), None)
                else:
                    last[(key, w[0], w[1])] = json.loads(value)
            order = np.lexsort((ts, url_idx))
            u_s, t_s, x_s = url_idx[order], ts[order], uid[order]
            new = np.ones(n, bool)
            new[1:] = (u_s[1:] != u_s[:-1]) | (t_s[1:] - t_s[:-1] > SESS_GAP_MS)
            starts = np.nonzero(new)[0]
            for s_, e_ in zip(starts, np.append(starts[1:], n) - 1):
                groups[(f"/page/{u_s[s_]}", int(t_s[s_]), int(t_s[e_]))] = x_s[s_:e_ + 1].tolist()
        else:
            last = {(k, w[0]): json.loads(v) for k, v, _t, w in sink_records(broker, topic)}
            size, adv = HOUR_MS, (HOP_ADVANCE_MS if tag == "23h" else HOUR_MS)
            for u, x, t in zip(url_idx.tolist(), uid.tolist(), ts.tolist()):
                w = t - t % adv
                while w > t - size:
                    groups.setdefault((f"/page/{u}", w), []).append(x)
                    w -= adv
        _check_offsets(last, offsets_model(groups), tag)
        route = ""
        if tag == "23h":
            require(not q.sliced and q.expansion == 4, "23h: not the expansion route")
            route = f"; expansion route: {q.windowing_fallback}"
            rec["windowing_fallback"] = q.windowing_fallback
        print(f"[{tag}] {name}: {n} events in batches of {rows}, {len(groups)} groups, "
              f"{rec['sink_records']} sink records; {rec['events_per_s']:.1f} events/s; batch p50 "
              f"{rec['p50_ms']:.3f} ms p99 {rec['p99_ms']:.3f} ms; peak device memory {rec['peak_bytes']} B; "
              f"store {q.store_capacity} slots after {q.grows} grows; sink equals the CPU run "
              f"({rec['cpu_s']:.3f} s), final values equal the numpy model (DECIMAL sums exact), overflow 0"
              f"{route}; seconds {time.perf_counter() - t0:.1f}")
        out[name] = dict(rec, groups=len(groups))
    return out


REPLACES = {
    "row_prologue": "ksql_tpu/ops/hash_store.py:48 (mix64), :58 (combine_hash); ksql_tpu/runtime/lowering.py:3802 (pre_exchange), :2284 (_trace_table_step key hash), :3483 (pre_session_exchange key hash), :2807/:2526/:2605 (_trace_tt_step/_trace_fk_left/_trace_fk_right key hash); ksql_tpu/ops/window.py:63 (hopping_starts), :82 (expand)",
    "probe_insert": "ksql_tpu/ops/hash_store.py:126 (probe_insert)",
    "fold_and_mark": "ksql_tpu/ops/hash_store.py:502 (scatter_combine; its argset branch :552-558 in the "
                     "argset mode), :567 (winners_per_slot)",
    "evict": "ksql_tpu/runtime/lowering.py:4239 (_trace_evict; the suppress guard and hpass clear, "
             ":4262-4273)",
    "sliced_fold": "ksql_tpu/runtime/lowering.py:1988 (_sliced_scatter)",
    "combine_windows": "ksql_tpu/runtime/lowering.py:2036 (_combine_windows), :4073 (_finalized_env gather)",
    "member_lanes": "ksql_tpu/runtime/lowering.py:2116 (_sliced_member_emits)",
    "probe_find": "ksql_tpu/ops/hash_store.py:210 (probe_find); ksql_tpu/runtime/lowering.py:2986 (_apply_join "
                  "gather), :2395-2397 (_ta_side's find-only probe), :2760 (_tt_joined_env's gathers), "
                  ":2554 (_trace_fk_left's right_of)",
    "table_upsert": "ksql_tpu/runtime/lowering.py:2284 (_trace_table_step, after its probe_insert), :2448 "
                    "(_upsert_side, with _trace_fk_left's fkrepr/fkvalid writes)",
    "ss_match": "ksql_tpu/runtime/lowering.py:3052 (_trace_ss_step: the match mask, nonzero compaction, "
                "gathers and any(axis=0), :3073-3170)",
    "ss_insert": "ksql_tpu/runtime/lowering.py:3052 (_trace_ss_step: running maxima, pads, admission, "
                 "ss_lost and the ring insert, :3104-3127 and :3169-3210)",
    "ss_expire": "ksql_tpu/runtime/lowering.py:3213 (_trace_ss_expire)",
    "seg_sort": "ksql_tpu/runtime/lowering.py:3537 (post_session_exchange: the jnp.lexsort of the rows "
                "and of the items, :3557 and :3618)",
    "session_items": "ksql_tpu/runtime/lowering.py:3483 (pre_session_exchange: the late drop), :3537 "
                     "(post_session_exchange: first_occ and the stored-session gather, :3557-3617)",
    "session_merge": "ksql_tpu/runtime/lowering.py:3537 (post_session_exchange: the sort-apply, "
                     "segmented scan, segment folds and rank, :3618-3715; the argset segment sum "
                     ":3671-3694 in the argset mode)",
    "session_write": "ksql_tpu/runtime/lowering.py:3537 (post_session_exchange: the deletes, the store "
                     "writes and the emission lanes, :3696-3799)",
    "suppress_clock": "ksql_tpu/runtime/lowering.py:3802 (pre_exchange: the suppress lanes, the running "
                      "stream times and the late cut, :3906-3931)",
    "suppress_close": "ksql_tpu/runtime/lowering.py:3953 (post_exchange: the suppress branch, :3997-4041)",
    "having_verdict": "ksql_tpu/runtime/lowering.py:4147 (_emit_agg: the HAVING verdict and retraction, "
                      ":4164-4199)",
    "vec_collect": "ksql_tpu/ops/hash_store.py:292 (_vec_collect), :271 (_batch_membership), :248 "
                   "(_slot_ranks), :403 (_vec_hist phase 1)",
    "vec_topk": "ksql_tpu/ops/hash_store.py:457 (_vec_topk), :260 (_sort_desc), :264 (_desc_key)",
    "vec_hist": "ksql_tpu/ops/hash_store.py:403 (_vec_hist phase 2)",
    "vec_remove": "ksql_tpu/ops/hash_store.py:337 (_vec_remove)",
    "fk_fanout": "ksql_tpu/runtime/lowering.py:2605 (_trace_fk_right: the match scan and the lenv/lkey lanes, "
                 ":2640-2672)",
    "tap_residual": "ksql_tpu/server/tap_kernel.py:265 (_lane_fn), vmapped over the lanes in :414-433 "
                    "(_LaneGroup.fn, _trace_group)",
}
#: the record each kernel's JSON entry carries; the other modes ride along
MAIN_MODE = {"fold_and_mark": "fold", "row_prologue": "tumbling", "evict": "tumbling", "combine_windows": "sliced",
             "sliced_fold": "sliced", "member_lanes": "sliced", "probe_find": "join",
             "table_upsert": "join", "ss_match": "write", "ss_insert": "write", "ss_expire": "ss",
             "seg_sort": "items", "session_items": "items", "session_merge": "merge",
             "session_write": "write", "vec_collect": "append", "vec_topk": "plain", "vec_hist": "hist",
             "vec_remove": "remove", "fk_fanout": "fanout", "tap_residual": "256x4096"}


def kernel_records(wrappers, recs) -> list:
    """The ``kernels`` line: per kernel its main mode's phase-2 record, its
    launches over the main-path phases (in all, by mode and by phase), its
    other modes' records, each with its launches, and its records at other
    shapes of a path (``shapes``: K2 at phase 19's)."""
    kernels = []
    for w in wrappers:
        name = w.__name__
        main_mode = MAIN_MODE.get(name, "tumbling")
        by_path = {p: PATH_LAUNCHES[p][name] for p in sorted(PATH_LAUNCHES)}
        by_mode = {m: sum(c[m] for c in by_path.values()) for m in by_path[min(by_path)]}
        kernels.append({
            "name": name, "route": "cuda", "source": f"ksql_tpu_torch/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": sum(by_mode.values()),
            **recs[name][main_mode], "mode": main_mode,
            "modes": {m: {**r, "launches": by_mode[m]} for m, r in recs[name].items()
                      if m != main_mode and m in by_mode},
            "shapes": {m: r for m, r in recs[name].items() if m != main_mode and m not in by_mode},
            "launches_by_mode": by_mode, "launches_by_path": by_path,
        })
    return kernels


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    try:
        import torch
    except ImportError:
        fail("PyTorch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device: this check runs only on the card")
    try:
        wrappers = _wrappers()
    except ImportError as e:
        fail(f"run from the root of a checkout ({e})")
    t_start = time.perf_counter()
    kind, smi = phase_device_and_build(torch)
    phase_launch_floor(torch)
    recs = {name: {"tumbling": rec} for name, rec in phase_kernels(torch, args.seed).items()}
    recs["fold_and_mark"]["fold"] = recs["fold_and_mark"].pop("tumbling")
    recs["probe_insert"][f"batch_{FINAL_GROW_ROWS}"] = phase_k2_batch(torch, args.seed, FINAL_GROW_ROWS)
    for name, modes in phase_hop_kernels(torch, args.seed).items():
        recs.setdefault(name, {}).update(modes)
    for name, modes in phase_join_kernels(torch, args.seed).items():
        recs.setdefault(name, {}).update(modes)
    # the stream-stream join's phases (2s, 10, 10g, 10b), timed together
    t_ss = time.perf_counter()
    for name, modes in phase_ss_kernels(torch, args.seed).items():
        recs.setdefault(name, {}).update(modes)
    ss_s = time.perf_counter() - t_ss
    with open("ksql_tpu_torch/plans/pv_sessions.json") as f:
        sess_json = json.load(f)
    # the session phases (2w, 11, 11g, 11b), timed together
    t_sess = time.perf_counter()
    sess_recs, sess_extra = phase_session_kernels(torch, sess_json, args.seed)
    for name, modes in sess_recs.items():
        recs.setdefault(name, {}).update(modes)
    sess_s = time.perf_counter() - t_sess
    # the EMIT FINAL and HAVING phases (2f, 12-13r), timed together
    t_final = time.perf_counter()
    final_recs, final_extra = phase_suppress_kernels(torch, args.seed)
    for name, modes in final_recs.items():
        recs.setdefault(name, {}).update(modes)
    final_s = time.perf_counter() - t_final
    # the vector aggregates' phases (2v, 14, 14h, 14b), timed together
    t_vec = time.perf_counter()
    vec_recs, vec_extra = phase_vector_kernels(torch, args.seed)
    for name, modes in vec_recs.items():
        recs.setdefault(name, {}).update(modes)
    vec_s = time.perf_counter() - t_vec
    # the table aggregation's phases (2t, 15, 16, 17, 15b), timed together
    t_ta = time.perf_counter()
    ta_recs, ta_extra = phase_table_agg_kernels(torch, args.seed)
    for name, modes in ta_recs.items():
        recs.setdefault(name, {}).update(modes)
    ta_s = time.perf_counter() - t_ta
    # the table-table and foreign-key joins' phases (2x, 18, 18b, 18g, 19), timed together
    t_tj = time.perf_counter()
    tj_recs, tj_extra = phase_table_join_kernels(torch, args.seed)
    for name, modes in tj_recs.items():
        recs.setdefault(name, {}).update(modes)
    tj_s = time.perf_counter() - t_tj
    # the push taps' phases (2p, 20, 21), timed together
    t_tap = time.perf_counter()
    recs["tap_residual"] = phase_tap_kernels(torch, args.seed)
    tap_s = time.perf_counter() - t_tap
    # the offsets' phases (2a, 22, 23, 23h, 23s), timed together
    t_off = time.perf_counter()
    for name, modes in phase_argset_kernels(torch, args.seed).items():
        recs.setdefault(name, {}).update(modes)
    off_s = time.perf_counter() - t_off
    with open("ksql_tpu_torch/plans/pv_counts_tumbling.json") as f:
        plan_json = json.load(f)
    with open("ksql_tpu_torch/plans/pv_stats_hopping.json") as f:
        hop_json = json.load(f)
    with open("ksql_tpu_torch/plans/enriched_join.json") as f:
        join_json = json.load(f)
    with open("ksql_tpu_torch/plans/ss_join_grace.json") as f:
        ss_json = json.load(f)
    e2e = phase_e2e(torch, plan_json, args.seed)
    phase_growth(torch, plan_json, args.seed)
    sliced_last, e2e["hopping_sliced"] = phase_hop_e2e(torch, hop_json, args.seed, None, "6")
    e2e["hopping_long"] = phase_hop_long(torch, hop_json, args.seed)
    exp_last, e2e["hopping_expansion"] = phase_hop_e2e(torch, hop_json, args.seed, False, "8")
    require(exp_last == sliced_last, "8: the expansion route's final values differ from the sliced route's")
    e2e["join"] = phase_join_e2e(torch, join_json, args.seed)
    e2e["join_growth"] = phase_join_growth(torch, join_json, args.seed)
    t_ss = time.perf_counter()
    e2e["ss_join"] = phase_ss_e2e(torch, ss_json, args.seed)
    e2e["ss_growth"] = phase_ss_growth(torch, ss_json, args.seed)
    ss_s += time.perf_counter() - t_ss
    t_sess = time.perf_counter()
    e2e["session"], sess_head = phase_session_e2e(torch, sess_json, args.seed)
    e2e["session_growth"] = phase_session_growth(torch, sess_json, args.seed, sess_head)
    e2e["session_kernels_extra"] = sess_extra
    sess_s += time.perf_counter() - t_sess
    t_final = time.perf_counter()
    plans = {}
    for name in ("pv_counts_final", "pv_stats_hopping_final", "possible_fraud", "pv_having_retract"):
        with open(f"ksql_tpu_torch/plans/{name}.json") as f:
            plans[name] = json.load(f)
    e2e["suppress_kernels_extra"] = final_extra
    e2e["emit_final"], e2e["emit_final_breakdown"] = phase_final_e2e(torch, plans["pv_counts_final"],
                                                                     args.seed)
    e2e["emit_final_growth"] = phase_final_growth(torch, plans["pv_counts_final"], args.seed)
    e2e["emit_final_hopping"] = phase_final_hop(torch, plans["pv_stats_hopping_final"], args.seed)
    e2e.update(phase_having_e2e(torch, plans["possible_fraud"], plans["pv_having_retract"], args.seed))
    final_s += time.perf_counter() - t_final
    t_vec = time.perf_counter()
    with open(VEC_PLAN) as f:
        vec_json = json.load(f)
    with open(HIST_PLAN) as f:
        hist_json = json.load(f)
    e2e["vector_kernels_extra"] = vec_extra
    e2e.update(phase_vector_e2e(torch, vec_json, hist_json, args.seed))
    vec_s += time.perf_counter() - t_vec
    t_ta = time.perf_counter()
    ta_plans = {}
    for name, path in (("users", USERS_PLAN), ("orders", ORDERS_PLAN), ("spenders", SPENDERS_PLAN)):
        with open(path) as f:
            ta_plans[name] = json.load(f)
    e2e["table_agg_kernels_extra"] = ta_extra
    e2e["users_by_region"] = phase_users_by_region(torch, ta_plans["users"], args.seed)
    e2e["customer_orders"] = phase_customer_orders(torch, ta_plans["orders"], args.seed)
    e2e["big_spenders"] = phase_big_spenders(torch, ta_plans["spenders"], args.seed)
    ta_s += time.perf_counter() - t_ta
    t_tj = time.perf_counter()
    with open(USER_ACCOUNTS_PLAN) as f:
        accounts_json = json.load(f)
    with open(ORDERS_ENRICHED_PLAN) as f:
        enriched_json = json.load(f)
    e2e["table_join_kernels_extra"] = tj_extra
    e2e["user_accounts"], e2e["user_accounts_breakdown"] = phase_user_accounts(torch, accounts_json, args.seed)
    e2e["tt_growth"] = phase_tt_growth(torch, accounts_json, args.seed)
    e2e["orders_enriched"] = phase_orders_enriched(torch, enriched_json, args.seed)
    tj_s += time.perf_counter() - t_tj
    t_tap = time.perf_counter()
    e2e["push_fanout"] = phase_push_fanout(torch, args.seed)
    e2e["push_listener"] = phase_push_listener(torch, args.seed)
    tap_s += time.perf_counter() - t_tap
    t_off = time.perf_counter()
    off_plans = {}
    for name, path in (("current_location", CURRENT_LOCATION_PLAN), ("pv_offsets", OFFSETS_PLAN),
                       ("pv_offsets_hopping", OFFSETS_HOP_PLAN), ("pv_offsets_session", OFFSETS_SESS_PLAN)):
        with open(path) as f:
            off_plans[name] = json.load(f)
    e2e["current_location"] = phase_current_location(torch, off_plans["current_location"], args.seed)
    e2e.update(phase_pv_offsets(torch, off_plans, args.seed))
    off_s += time.perf_counter() - t_off
    require(sorted(PATH_LAUNCHES) == sorted(PATH_KERNELS), f"paths run: {sorted(PATH_LAUNCHES)}")
    for w in wrappers:  # every kernel of K1-K25 is on some path, in every mode
        for mode in w.__dict__.get("mode_launches", {"all": 0}):
            require(sum(PATH_LAUNCHES[p][w.__name__][mode] for p in PATH_LAUNCHES) > 0,
                    f"kernel {w.__name__}[{mode}] was launched on no path")
    url_idx, ts = _flagship_head(args.seed, BREAKDOWN_BATCHES)
    e2e["breakdown"] = phase_breakdown(
        torch, lambda: run_main_path(torch, plan_json, url_idx, ts, DEVICE, STORE)[2], BREAKDOWN_BATCHES, "3b")
    url_idx, uid, ts = hop_traffic(args.seed, n_batches=BREAKDOWN_BATCHES)
    e2e["hopping_breakdown"] = phase_breakdown(
        torch, lambda: run_main_path(torch, hop_json, url_idx, ts, DEVICE, STORE, rows=HOP_ROWS,
                                     user_ids=uid)[2], BREAKDOWN_BATCHES, "6b")
    e2e["join_breakdown"] = phase_breakdown(torch, _join_head(torch, join_json, args.seed, BREAKDOWN_BATCHES),
                                            BREAKDOWN_BATCHES, "9b")
    t_ss = time.perf_counter()
    e2e["ss_breakdown"] = phase_breakdown(torch, _ss_head(torch, ss_json, args.seed, n_batches=BREAKDOWN_BATCHES),
                                          BREAKDOWN_BATCHES, "10b")
    ss_s += time.perf_counter() - t_ss
    t_sess = time.perf_counter()
    e2e["session_breakdown"] = phase_breakdown(torch, _session_head(torch, sess_json, n_batches=BREAKDOWN_BATCHES),
                                               BREAKDOWN_BATCHES, "11b")
    sess_s += time.perf_counter() - t_sess
    t_vec = time.perf_counter()
    e2e["vector_breakdown"] = phase_breakdown(torch, _vector_head(torch, vec_json, args.seed),
                                              VEC_BREAKDOWN_BATCHES, "14b")
    vec_s += time.perf_counter() - t_vec
    t_ta = time.perf_counter()
    e2e["users_by_region_breakdown"] = phase_breakdown(
        torch, _users_head(torch, ta_plans["users"], args.seed), TA_BREAKDOWN_BATCHES, "15b")
    ta_s += time.perf_counter() - t_ta
    kernels = kernel_records(wrappers, recs)
    print(f"e2e: {json.dumps(e2e)}")
    print(f"total seconds {time.perf_counter() - t_start:.1f} (phases 2s, 10, 10g and 10b: {ss_s:.1f}; "
          f"phases 2w, 11, 11g and 11b: {sess_s:.1f}; phases 2f, 12 (with 12b) to 13r: {final_s:.1f}; "
          f"phases 2v, 14, 14h and 14b: {vec_s:.1f}; phases 2t, 15, 16, 17 and 15b: {ta_s:.1f}; "
          f"phases 2x, 18, 18b, 18g and 19: {tj_s:.1f}; phases 2p, 20 and 21: {tap_s:.1f}; "
          f"phases 2a, 22, 23, 23h and 23s: {off_s:.1f})")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                              "count": torch.cuda.device_count()}}))
    return 0


def _join_head(torch, join_json, seed, n_batches=4):
    """Phase 9's table load and its first ``n_batches`` stream batches,
    produced; returns the drive of the breakdown's window: polling the
    stream batches (and the last table batch, which the first stream row
    runs) through the runner, in wall seconds."""
    from ksql_tpu_torch.runner import run_until_quiescent, start_plan
    from ksql_tpu_torch.runtime.topics import Broker

    broker = Broker()
    h = start_plan(join_json, broker, device=DEVICE, capacity=JOIN_ROWS, table_store_capacity=JOIN_STORE)
    produce_users(broker, list(range(JOIN_USERS)), [f"r{k % N_REGIONS}" for k in range(JOIN_USERS)], TS0)
    run_until_quiescent(h)
    rng = np.random.default_rng(seed + 5)
    n = n_batches * JOIN_ROWS
    produce_clicks(broker, rng.integers(0, 2 * JOIN_USERS, n), TS0 + 1 + np.arange(n, dtype=np.int64) * 3)

    def drive():
        t0 = time.perf_counter()
        run_until_quiescent(h)
        h.executor.drain()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    return drive


def _flagship_head(seed, n_batches=4):
    """The first batches of the flagship e2e traffic (phase 3)."""
    rng = np.random.default_rng(seed + 1)
    n = N_BATCHES * N_ROWS
    url_idx = (rng.zipf(1.3, size=n).astype(np.int64) % N_URLS)[: n_batches * N_ROWS]
    return url_idx, TS0 + np.arange(url_idx.size, dtype=np.int64) * 17


if __name__ == "__main__":
    sys.exit(main())
