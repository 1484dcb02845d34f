"""The port's CUDA kernels against their plain torch twins, on the card.

These tests need an NVIDIA card with the CUDA toolkit (the kernels are
compiled with nvcc at first use); without one each test skips from its
fixture.  Run them on the card with

    python -m pytest -m gpu tests/test_torch_kernels_gpu.py

Ints, bools, hashes and slots must be equal; float64 sums agree to rtol
1e-12 (atomic fold order is not fixed).
"""

import numpy as np
import pytest
import torch

from ksql_tpu_torch.ops import hash_store as hs

pytestmark = pytest.mark.gpu
I64 = np.iinfo(np.int64)
HOUR = 3_600_000


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _same(a, b, rtol=0.0):
    a, b = a.cpu(), b.cpu()
    assert a.dtype == b.dtype and a.shape == b.shape
    if a.is_floating_point():
        assert torch.isclose(a, b, rtol=rtol, atol=0.0, equal_nan=True).all()
    else:
        assert torch.equal(a, b)


def _prologue_inputs(dev, n, k, seed):
    rng = np.random.default_rng(seed)
    reprs = torch.from_numpy(rng.integers(I64.min, I64.max, (k, n), dtype=np.int64)).to(dev)
    valid = torch.from_numpy(rng.random((k, n)) > 0.05).to(dev)
    max_ts = 472_222 * HOUR
    ts = max_ts - rng.integers(-HOUR, 40 * HOUR, n)
    # windows that end exactly at max_ts - grace (dropped) and one ms later
    ts[:6] = max_ts - 25 * HOUR + np.array([0, HOUR - 1, HOUR, HOUR + 1, -1, -HOUR])
    ts[6:10] = -np.array([1, HOUR, HOUR + 1, 7])  # negative: floor, not truncate
    ts = torch.from_numpy(ts).to(dev)
    active = torch.from_numpy(rng.random(n) > 0.1).to(dev)
    max_ts = torch.tensor(max_ts, device=dev)
    return reprs, valid, ts, active, max_ts


@pytest.mark.parametrize("k,size", [(1, HOUR), (3, HOUR), (2, 0)])
def test_row_prologue_kernel_matches_twin(dev, k, size):
    reprs, valid, ts, active, max_ts = _prologue_inputs(dev, 5000, k, k)
    args = (reprs, valid, ts, active, size, 24 * HOUR, max_ts, 1 << 12)
    before = hs.row_prologue.launches
    got = hs.row_prologue(*args)
    assert hs.row_prologue.launches == before + 1
    for g, w in zip(got, hs.row_prologue_plain(*args)):
        _same(g, w)


def _store(dev, capacity, fill, graves, seed):
    rng = np.random.default_rng(seed)
    layout = hs.StoreLayout(capacity, 1, (
        hs.AggComponent("max", "int64", I64.min),
        hs.AggComponent("add", "int64", 0),
        hs.AggComponent("add", "float64", 0.0),
        hs.AggComponent("min", "float64", float("inf")),
    ), windowed=True)
    st = {k: v.numpy().copy() for k, v in hs.init_store(layout, "cpu").items()}
    kh = rng.integers(I64.min, I64.max, fill, dtype=np.int64)
    slots = hs.host_insert(st["occ"], st["khash"], st["wstart"], capacity, kh, np.zeros(fill, np.int64))
    st["key0"][slots] = kh
    st["occ"][slots[:graves]] = False
    st["grave"][slots[:graves]] = True
    return layout, {k: torch.from_numpy(v).to(dev) for k, v in st.items()}


@pytest.mark.parametrize("capacity,fill,graves,n", [(1 << 12, 1500, 200, 2048), (1 << 7, 60, 20, 512)])
def test_probe_insert_and_fold_kernels_match_twins(dev, capacity, fill, graves, n):
    layout, st = _store(dev, capacity, fill, graves, seed=capacity)
    rng = np.random.default_rng(1)
    live = np.nonzero((st["occ"] | st["grave"]).cpu().numpy()[:-1])[0]
    khash = rng.integers(I64.min, I64.max, n, dtype=np.int64)
    pick = live[rng.integers(0, live.size, n // 2)]
    khash[: n // 2] = st["khash"].cpu().numpy()[pick]
    khash = torch.from_numpy(khash[rng.integers(0, n, n)]).to(dev)  # duplicates
    wstart = torch.zeros(n, dtype=torch.int64, device=dev)
    reprs = khash.reshape(1, n).clone()
    knull = torch.zeros(n, dtype=torch.int32, device=dev)
    active = torch.from_numpy(rng.random(n) > 0.1).to(dev)
    base = hs.slot_base(khash, wstart, capacity)
    sk = {k: v.clone() for k, v in st.items()}
    sp = {k: v.clone() for k, v in st.items()}
    scratch = hs.init_scratch(capacity, dev)
    slots = hs.probe_insert(sk, scratch, capacity, base, khash, wstart, reprs, knull, active)
    want = hs.probe_insert_plain(sp, capacity, base, khash, wstart, reprs, knull, active)
    _same(slots, want)
    for k in st:
        _same(sk[k], sp[k])
    assert (scratch["claim"] == hs.INT32_MAX).all()
    x = torch.from_numpy(rng.standard_normal(n)).to(dev)
    contribs = [
        torch.where(active, torch.arange(n, device=dev), torch.full((n,), I64.min, device=dev)),
        active.long(), torch.where(active, x, torch.zeros_like(x)),
        torch.where(active, x, torch.full_like(x, float("inf"))),
    ]
    win_k = hs.fold_and_mark(sk, scratch, layout, slots, contribs, active)
    win_p = hs.fold_and_mark_plain(sp, layout, slots, contribs, active)
    _same(win_k, win_p)
    for k in st:
        _same(sk[k], sp[k], rtol=1e-12)
    assert (scratch["first"] == hs.INT32_MAX).all()


def test_evict_kernel_matches_twin(dev):
    layout, st = _store(dev, 1 << 12, 2000, 100, seed=5)
    occ = st["occ"].cpu().numpy()
    st["wstart"] = torch.from_numpy(np.where(occ, np.arange(occ.size) % 50 * HOUR, 0)).to(dev)
    st["max_ts"].fill_(40 * HOUR)
    sk = {k: v.clone() for k, v in st.items()}
    sp = {k: v.clone() for k, v in st.items()}
    hs.evict(sk, layout, 25 * HOUR)
    hs.evict_plain(sp, layout, 25 * HOUR)
    for k in st:
        _same(sk[k], sp[k])
    assert (st["occ"] & ~sk["occ"]).any()


def test_cuda_tensor_never_takes_the_twin(dev):
    # a CUDA tensor of the wrong dtype is refused, not routed to the twin
    reprs, valid, ts, active, max_ts = _prologue_inputs(dev, 64, 1, 0)
    with pytest.raises(ValueError):
        hs.row_prologue(reprs.to(torch.int32), valid, ts, active, HOUR, 0, max_ts, 64)
