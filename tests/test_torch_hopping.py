"""HOPPING aggregation: TorchCompiledQuery against CompiledDeviceQuery.

Both routes of the reference — stream slicing (``sliced=None``, the
default when eligible) and the k-fold expansion (``sliced=False``) — run
through ``test_torch_lowering.run_parity``: the same plan, the same encoded
micro-batches, and after EVERY step the full state dict (the 2-D slice
ring, ``slice_id``, ``slast`` and the dump row included) and every emit
lane compared bit for bit.  The cases are ``test_slicing.py``'s hopping
corpus and ring tests, BASELINE #2's plan, ring resizes with recycled
cells, store growth, the sliced retention pass and a hand-over of
mid-stream reference state; the expansion-route fallback reasons must be
the reference's strings.
"""

import json

import numpy as np
import pytest

from ksql_tpu.execution.steps import plan_to_json
from ksql_tpu.runtime.lowering import CompiledDeviceQuery
from ksql_tpu_torch.compiler.torch_expr import DeviceUnsupported
from ksql_tpu_torch.execution.steps import plan_from_json
from ksql_tpu_torch.ops import slicing
from ksql_tpu_torch.runtime.lowering import TorchCompiledQuery
from tests.test_slicing import HOPPING_CORPUS, gen_rows
from tests.test_torch_lowering import DDL, PV_DDL, gen_batches, plan_for, run_parity

BASELINE2 = (
    "CREATE TABLE PV_STATS AS SELECT URL, SUM(USER_ID) AS S, AVG(USER_ID) AS A, "
    "MIN(USER_ID) AS MN, MAX(USER_ID) AS MX FROM PAGE_VIEWS "
    "WINDOW HOPPING (SIZE 1 HOUR, ADVANCE BY 15 MINUTES) GROUP BY URL EMIT CHANGES;"
)


def chunks(rows, size):
    return [([r for r, _ in rows[i:i + size]], [t for _, t in rows[i:i + size]])
            for i in range(0, len(rows), size)]


@pytest.mark.parametrize("sliced", [None, False])
@pytest.mark.parametrize("disorder_ms", [0, 3000])
@pytest.mark.parametrize("query,k", HOPPING_CORPUS)
def test_hopping_corpus_parity(query, k, disorder_ms, sliced):
    rows = gen_rows(160, seed=k + disorder_ms, disorder_ms=disorder_ms)
    ref_q, q = run_parity(DDL, query, chunks(rows, 16), capacity=16, store=1024, sliced=sliced)
    assert q.sliced == ref_q.sliced == (sliced is None)
    assert q.hop_k == ref_q.hop_k == k
    assert q.windowing_fallback == ref_q.windowing_fallback


@pytest.mark.parametrize("sliced", [None, False])
def test_baseline2_plan_parity(sliced):
    # ~3 h of event time per 10 batches, 60 URLs, late records past grace
    batches = gen_batches(4, 10, 48, urls=60, ts_step=200_000, pv=True)
    ref_q, q = run_parity(PV_DDL, BASELINE2, batches, capacity=48, store=1 << 20,
                          sliced=sliced, evict_interval=4)
    if sliced is None:
        assert q.sliced and q.hop_k == 4
        # the budget clamp: 56 B x 102 ring cells per slot -> 2^15 slots
        assert ref_q.store_layout.capacity == 1 << 15
        assert q.ring_resizes >= 1
    else:
        assert not q.sliced and q.store_capacity == 1 << 20


def test_sliced_single_batch_spanning_many_slices(monkeypatch):
    # one batch spans ~3 min of 1 s slices against a 16-slice ring (a ring
    # resize), then later batches wrap the ring: recycled cells reset
    recycled = []
    fold = slicing.sliced_fold

    def counting_fold(store, scratch, layout, slots, wstart, contribs, active, width):
        ring = layout.components[0].width
        sidx = wstart // width
        live = active & (slots != layout.capacity)
        cur = store["slice_id"][slots.long().clamp(max=layout.capacity), sidx % ring]
        recycled.append(int((live & (cur >= 0) & (cur != sidx)).sum()))
        return fold(store, scratch, layout, slots, wstart, contribs, active, width)

    monkeypatch.setattr(slicing, "sliced_fold", counting_fold)
    rows = gen_rows(200, seed=9, step_ms=900)
    later = [(r, t + rows[-1][1] + 60_000) for r, t in gen_rows(96, seed=10, step_ms=2500)]
    batches = [([r for r, _ in rows], [t for _, t in rows])] + chunks(later, 32)
    ref_q, q = run_parity(DDL, HOPPING_CORPUS[0][0], batches, capacity=200, store=256)
    assert q.sliced and q.slice_ring == ref_q.slice_ring > 16
    assert sum(recycled) > 0


def test_ring_cap_blowout_keeps_expansion():
    # the default 24 h grace over a seconds-scale hop blows the ring cap
    query = ("CREATE TABLE T AS SELECT URL, COUNT(*) AS CNT FROM PAGE_VIEWS "
             "WINDOW HOPPING (SIZE 4 SECONDS, ADVANCE BY 2 SECONDS) GROUP BY URL EMIT CHANGES;")
    engine, plan, _schema = plan_for(DDL, query)
    ref_q = CompiledDeviceQuery(plan, engine.registry, capacity=8)
    q = TorchCompiledQuery(plan_from_json(plan_to_json(plan)), capacity=8, device="cpu")
    assert not q.sliced and not ref_q.sliced
    assert q.windowing_fallback == ref_q.windowing_fallback
    assert "ksql.slicing.max.ring" in q.windowing_fallback
    rows = gen_rows(64, seed=4, step_ms=700)
    run_parity(DDL, query, chunks(rows, 16), capacity=16, store=1024)


FALLBACKS = {
    "k1": ("CREATE TABLE T AS SELECT URL, COUNT(*) AS CNT FROM PAGE_VIEWS WINDOW HOPPING "
           "(SIZE 4 SECONDS, ADVANCE BY 4 SECONDS, GRACE PERIOD 2 SECONDS) GROUP BY URL;", {}),
    "cap": (HOPPING_CORPUS[2][0], {"slice_ring_max": 8}),
    "disabled": (HOPPING_CORPUS[0][0], {"sliced": False}),
}


@pytest.mark.parametrize("name", list(FALLBACKS))
def test_windowing_fallback_reasons_equal_reference(name):
    query, kw = FALLBACKS[name]
    engine, plan, _schema = plan_for(DDL, query)
    ref_q = CompiledDeviceQuery(plan, engine.registry, capacity=8, **kw)
    q = TorchCompiledQuery(plan_from_json(plan_to_json(plan)), capacity=8, device="cpu", **kw)
    assert not ref_q.sliced and not q.sliced
    assert q.windowing_fallback == ref_q.windowing_fallback is not None
    if "sliced" not in kw:
        with pytest.raises(DeviceUnsupported, match=q.windowing_fallback[:20]):
            TorchCompiledQuery(plan_from_json(plan_to_json(plan)), capacity=8, device="cpu",
                               sliced=True, **kw)


def test_sliced_requires_hopping():
    _engine, plan, _schema = plan_for(
        DDL, "CREATE TABLE C AS SELECT URL, COUNT(*) AS CNT FROM PAGE_VIEWS "
             "WINDOW TUMBLING (SIZE 1 HOUR) GROUP BY URL;")
    with pytest.raises(DeviceUnsupported, match="requires a HOPPING"):
        TorchCompiledQuery(plan_from_json(plan_to_json(plan)), capacity=8, device="cpu",
                           sliced=True)


@pytest.mark.parametrize("sliced,store", [(None, 64), (False, 256)])
def test_hopping_grow_and_evict_parity(sliced, store):
    # 300 URLs through the pipelined double buffer into a small store (it
    # grows; the expansion route's k = 3 lanes per row need 256 slots to
    # see a load check before the reference's store overflows), ~25 min of
    # event time against a 14 s retention with a pass every 4 batches
    # (sliced slots expire by their newest slice)
    batches = gen_batches(11, 16, 16, urls=300, ts_step=6_000)
    query = HOPPING_CORPUS[1][0]
    ref_q, q = run_parity(DDL, query, batches, capacity=16, store=store, evict_interval=4,
                          sliced=sliced, pipeline=True)
    assert q.grows >= 1 and q.evictions >= 3
    assert q.sliced == (sliced is None)
    assert bool(np.asarray(ref_q.state["grave"]).any()) or q.compactions > 0


@pytest.mark.parametrize("sliced,store", [(None, 512), (False, 2048)])
def test_hopping_handoff_of_midstream_reference_state(sliced, store):
    # the reference runs the first half (ring resizes, retention passes);
    # the port takes over its state and ring and must continue bit for bit
    batches = gen_batches(12, 12, 32, urls=50, ts_step=3_000)
    _ref_q, q = run_parity(DDL, HOPPING_CORPUS[1][0], batches, capacity=32, store=store,
                           evict_interval=4, handoff_at=6, sliced=sliced)
    assert int(q.state["overflow"]) == 0


def test_hopping_plan_file_runs_sliced():
    with open("ksql_tpu_torch/plans/pv_stats_hopping.json") as f:
        plan = plan_from_json(json.load(f))
    q = TorchCompiledQuery(plan, capacity=16, store_capacity=1 << 20, device="cpu")
    assert q.sliced and q.slice_ring == 102 and q.hop_k == 4
    assert q.store_capacity == 1 << 15
