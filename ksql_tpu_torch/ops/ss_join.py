"""Stream-stream windowed join on the card: the WITHIN-window match, the
ring-buffer insert and the buffer expiry.

The port of ``ksql_tpu/runtime/lowering.py``'s ``_trace_ss_step`` (B14) and
``_trace_ss_expire`` (B15).  Each side of the join buffers its rows in a
ring of ``B + 1`` entries on the card, ``B`` the ring capacity and entry
``B`` the dump entry that absorbs the rows a batch does not admit.  A
ring is a dict of tensors (``RING_FIELDS`` plus the buffered columns):

* ``ts`` int64, ``krepr`` int64 (the join key's 64-bit repr), ``kval``
  bool (key not null), ``live`` bool, ``matched`` bool (the entry has
  joined, or was null-padded), ``seq`` int64 (arrival order)

Three hand-written CUDA kernels (``csrc/``) carry the work:

* K10 ``ss_match``: :func:`ss_match_count` counts each incoming row's
  matches in the opposite ring, tile by tile of the ring in shared
  memory, and scans the counts in the same launch (its last block; no
  state written); :func:`ss_match` writes the k-th match in row-major
  (row, entry) order to output lane ``k`` with its gathers, re-testing
  only the (row tile, ring tile) pairs the count found matches in, and
  marks the matched opposite entries.
* K11 ``ss_insert``: :func:`ss_insert_prologue` computes the pads, the
  admissions, the target entries and the overwrite loss (one launch, no
  state written); :func:`ss_insert` writes the admitted rows into the
  own ring, the dump entry, the cursor and both stream clocks.
* K12 ``ss_expire``: closes, pads and evicts the entries of both rings in
  place and writes the expiry's emission lanes.

The split lets the caller read the match total and the loss once, grow,
and only then write any state: the reference re-runs a functional step
on the old state instead.  As in ``ops/hash_store.py``, each wrapper
launches its kernel for CUDA tensors and counts the launch in
``<kernel>.launches`` and ``<kernel>.mode_launches[mode]``
(``count``/``write``, ``prologue``/``write``; K12 has one mode); for CPU
tensors it runs the plain torch twin beside it (``*_plain``), which is
also the kernel's oracle on the card.  Every int64 sum wraps, as XLA's.
"""

from __future__ import annotations

import weakref
from typing import Dict, List, Sequence, Tuple

import torch

from ksql_tpu_torch.compiler.torch_expr import decode_key64
from ksql_tpu_torch.ops import cuda
from ksql_tpu_torch.ops.hash_store import Lanes, _expect, _stream

INT64_MIN = -(1 << 63)
#: ``ord_b`` of a right-ring entry in the expiry's order (left entries first)
SIDE_RANK_R = 1 << 40
RING_FIELDS = ("ts", "krepr", "kval", "live", "matched", "seq")
_RING_DTYPES = {"ts": torch.int64, "krepr": torch.int64, "kval": torch.bool,
                "live": torch.bool, "matched": torch.bool, "seq": torch.int64}

Ring = Dict[str, torch.Tensor]
Cols = Sequence[Tuple[torch.Tensor, torch.Tensor]]


def init_ring(b1: int, device) -> Ring:
    return {f: torch.zeros(b1, dtype=dt, device=device) for f, dt in _RING_DTYPES.items()}


def _window(side: str, ts, ots, before: int, after: int):
    """The WITHIN window, bounds inclusive: a left row at ``ts`` takes
    right entries in [ts - before, ts + after]; a right row at ``ts`` left
    entries with ts in [ots - before, ots + after]."""
    if side == "l":
        return (ts - before <= ots) & (ots <= ts + after)
    return (ots - before <= ts) & (ts <= ots + after)


def _matches(side, krepr, kvalid, active, ts, ring: Ring, before, after):
    """Every (row, entry) match, in row-major order: ``(i, j)``.  The mask
    is taken over the rows that can match (active, valid key) and the
    entries that can (live, valid key) only; both index lists ascend, so
    the order is the full mask's."""
    rows = (active & kvalid).nonzero().squeeze(1)
    ents = (ring["live"] & ring["kval"]).nonzero().squeeze(1)
    m = (krepr[rows][:, None] == ring["krepr"][ents][None, :]) & _window(
        side, ts[rows][:, None], ring["ts"][ents][None, :], before, after)
    ri, ji = m.nonzero(as_tuple=True)
    return rows[ri], ents[ji]


# ------------------------------------------------------- K10: ss_match
def ss_match_count_plain(side, krepr, kvalid, active, ts, ring: Ring, before, after):
    """Plain twin of K10's count and scan — see :func:`ss_match_count`."""
    i, _j = _matches(side, krepr, kvalid, active, ts, ring, before, after)
    cnt = torch.bincount(i, minlength=krepr.shape[0])
    return cnt, cnt > 0, torch.cumsum(cnt, 0) - cnt, cnt.sum()


class MatchCount(tuple):
    """K10's count on the card: the tuple ``(cnt, row_matched, offsets,
    total)`` of :func:`ss_match_count_plain`, and beside it ``tcnt``, the
    int32 match counts per (ring chunk, row) (chunk-major, ``chunks x n``)
    and the ``span`` of kernel tiles a chunk holds, which the write reads:
    all of it views of one allocation."""

    def __new__(cls, items, tcnt: torch.Tensor, span: int):
        self = super().__new__(cls, items)
        self.tcnt = tcnt
        self.span = span
        return self


def _chunks(b1: int) -> Tuple[int, int]:
    """K10's ring chunks for a ring of ``b1`` entries: ``(span, chunks)``,
    a chunk ``span`` kernel tiles of _TILE entries, span 1 until the ring
    passes _MAX_CHUNKS tiles."""
    tiles = -(-b1 // _TILE)
    span = -(-tiles // _MAX_CHUNKS)
    return span, -(-b1 // (_TILE * span))


def ss_match_count(side: str, krepr: torch.Tensor, kvalid: torch.Tensor, active: torch.Tensor,
                   ts: torch.Tensor, ring: Ring, before: int, after: int):
    """K10, count mode (replaces the n x (B+1) mask, its sum and its
    ``any(axis=1)`` in ``runtime/lowering.py:_trace_ss_step``): per
    incoming row of side ``side`` (``"l"`` or ``"r"``), the entries of the
    opposite ``ring`` it joins: active row with a valid key, live entry
    with a valid key, equal key reprs, entry inside the row's WITHIN window.
    Returns ``(cnt, row_matched, offsets, total)``: int64 matches per row,
    ``cnt > 0``, their exclusive prefix sum and the 0-d total (on the card
    a :class:`MatchCount`, which also carries the per-chunk counts the
    write reads).  One launch: blocks test 256 rows each against a ring
    tile in shared memory, and the last block sums and scans.  Writes no
    state."""
    if not krepr.is_cuda:
        return ss_match_count_plain(side, krepr, kvalid, active, ts, ring, before, after)
    n = krepr.shape[0]
    plan = ring_plan(ring)
    _check_rows(n, krepr=krepr, ts=ts, kvalid=kvalid, active=active)
    span, chunks = _chunks(plan.b1)
    # one allocation: cnt, offsets, total (int64), tcnt (int32), row_matched
    tw = -(-(chunks * n) // 2)
    buf = torch.empty(2 * n + 1 + tw + -(-n // 8), dtype=torch.int64, device=krepr.device)
    cnt, offsets, total = buf[:n], buf[n:2 * n], buf[2 * n]
    tcnt = buf[2 * n + 1:2 * n + 1 + tw].view(torch.int32)[:chunks * n].view(chunks, n)
    row_matched = buf[2 * n + 1 + tw:].view(torch.bool)[:n]
    fn = cuda.lib("ss_match", "ksql_ss_match_count")
    cuda.check("ss_match", fn(
        _SIDES[side], krepr.data_ptr(), kvalid.data_ptr(), active.data_ptr(), ts.data_ptr(), n,
        *plan.match_ptrs, plan.b1, before, after, span, tcnt.data_ptr(), cnt.data_ptr(),
        row_matched.data_ptr(), offsets.data_ptr(), total.data_ptr(), plan.ticket_ptr,
        plan.row_totals(n), _stream(krepr.device),
    ))
    ss_match.launches += 1
    ss_match.mode_launches["count"] += 1
    return MatchCount((cnt, row_matched, offsets, total), tcnt, span)


def ss_match_plain(side, krepr, kvalid, active, ts, ring: Ring, before, after, count, oc: int,
                   own_cols: Cols, opp_cols: Cols) -> Dict[str, object]:
    """Plain twin of K10's write — see :func:`ss_match` (``count`` unused:
    the twin finds the matches again)."""
    i, j = _matches(side, krepr, kvalid, active, ts, ring, before, after)
    ring["matched"][j] = True
    k = min(i.numel(), oc)
    dev = krepr.device
    mi = torch.zeros(oc, dtype=torch.int64, device=dev)
    mj = torch.zeros(oc, dtype=torch.int64, device=dev)
    mi[:k], mj[:k] = i[:k], j[:k]
    mvalid = torch.arange(oc, device=dev) < k
    return {
        "mi": mi.to(torch.int32), "mj": mj.to(torch.int32), "mvalid": mvalid,
        "ts": torch.maximum(ts[mi], ring["ts"][mj]), "ord_b": ring["seq"][mj],
        "own": [(d[mi], v[mi] & mvalid) for d, v in own_cols],
        "opp": [(d[mj], v[mj] & mvalid) for d, v in opp_cols],
    }


def ss_match(side: str, krepr: torch.Tensor, kvalid: torch.Tensor, active: torch.Tensor,
             ts: torch.Tensor, ring: Ring, before: int, after: int, count, oc: int,
             own_cols: Cols, opp_cols: Cols) -> Dict[str, object]:
    """K10, write mode (replaces the ``nonzero(size=oc, fill_value=0)``
    compaction, the match lanes' gathers and ``any(axis=0)`` of
    ``runtime/lowering.py:_trace_ss_step``): the k-th match in row-major
    (row, entry) order becomes output lane ``k < oc``, with its row ``mi``,
    entry ``mj``, ``ts = max(ts[mi], ring ts[mj])``, ``ord_b = ring
    seq[mj]``, ``mvalid`` and per column of ``own_cols`` (the row side's
    ``(data, valid)``) and ``opp_cols`` (the ring's) the value at
    ``mi``/``mj`` with its valid bit.  Lanes past the matches read row 0
    and entry 0 with every valid bit False, as ``fill_value=0`` does.
    Sets ``ring["matched"]`` of every matched entry in place.  ``count``
    is :func:`ss_match_count`'s result on the same inputs: the launch
    re-tests only the (row tile, ring chunk) pairs it counted matches in,
    and writes lanes of one allocation."""
    if not krepr.is_cuda:
        return ss_match_plain(side, krepr, kvalid, active, ts, ring, before, after, count, oc,
                              own_cols, opp_cols)
    n = krepr.shape[0]
    plan = ring_plan(ring)
    _check_rows(n, krepr=krepr, ts=ts, kvalid=kvalid, active=active)
    span, chunks = _chunks(plan.b1)
    if not isinstance(count, MatchCount) or count.span != span or tuple(count.tcnt.shape) != (chunks, n):
        raise ValueError("ss_match: count is not ss_match_count's result on this batch and ring")
    _cnt, _row_matched, offsets, total = count
    if len(own_cols) > 32:
        raise ValueError("more than 32 own columns")
    own_ptrs: List[int] = []
    for d, v in own_cols:
        _expect(d, d.dtype, (n,))
        _expect(v, torch.bool, (n,))
        own_ptrs += [d.data_ptr(), v.data_ptr()]
    desc = plan.write_desc(opp_cols, tuple(d.dtype for d, _v in own_cols))
    dev = krepr.device
    buf = desc.lanes.alloc(oc, dev)
    fn = cuda.lib("ss_match", "ksql_ss_match_write")
    cuda.check("ss_match", fn(
        _SIDES[side], krepr.data_ptr(), kvalid.data_ptr(), active.data_ptr(), ts.data_ptr(), n,
        *plan.match_ptrs, plan.seq_ptr, plan.matched_ptr, plan.b1, before, after, span,
        count.tcnt.data_ptr(), offsets.data_ptr(), total.data_ptr(), oc, desc.ptr, desc.words,
        cuda.host_i64(own_ptrs), len(own_cols), buf.data_ptr(), _stream(dev),
    ))
    ss_match.launches += 1
    ss_match.mode_launches["write"] += 1
    (lanes,) = desc.lanes.views(buf, oc, oc)
    out: Dict[str, object] = {k: lanes[k] for k in ("mi", "mj", "mvalid", "ts", "ord_b")}
    out["own"] = [(lanes[f"own_v{c}"], lanes[f"own_m{c}"]) for c in range(len(own_cols))]
    out["opp"] = [(lanes[f"opp_v{c}"], lanes[f"opp_m{c}"]) for c in range(len(opp_cols))]
    return out


ss_match.launches = 0
ss_match.mode_launches = {"count": 0, "write": 0}

#: K10's ring tile (csrc/ss_match.cu kTile) and the most chunks a count
#: keeps a row (past them a chunk holds several tiles)
_TILE = 512
_MAX_CHUNKS = 64


class WriteDesc:
    """K10's write descriptor for one set of ring columns and own-column
    dtypes: the device words of csrc/ss_match.cu (the ring columns'
    arrays and element bytes, each output lane's byte offset per output
    row) and the :class:`Lanes` layout of the outputs."""

    def __init__(self, opp_cols: Cols, own_dtypes, dev):
        self.refs = [(weakref.ref(d), weakref.ref(v)) for d, v in opp_cols]
        groups: Dict[torch.dtype, List[str]] = {torch.int64: ["ts", "ord_b"], torch.int32: ["mi", "mj"],
                                                torch.bool: ["mvalid"]}
        for c, dt in enumerate(own_dtypes):
            groups.setdefault(dt, []).append(f"own_v{c}")
            groups[torch.bool].append(f"own_m{c}")
        for c, (d, _v) in enumerate(opp_cols):
            groups.setdefault(d.dtype, []).append(f"opp_v{c}")
            groups[torch.bool].append(f"opp_m{c}")
        self.lanes = Lanes(list(groups.items()))
        rel = self.lanes.offsets(1)[0]  # bytes per output row: a lane of oc rows starts at oc times it
        words = [len(own_dtypes), len(opp_cols)] + [rel[k] for k in ("mi", "mj", "ts", "ord_b", "mvalid")]
        for c, dt in enumerate(own_dtypes):
            words += [dt.itemsize, rel[f"own_v{c}"], rel[f"own_m{c}"]]
        for c, (d, v) in enumerate(opp_cols):
            words += [d.data_ptr(), d.element_size(), v.data_ptr(), rel[f"opp_v{c}"], rel[f"opp_m{c}"]]
        self.desc = torch.tensor(words, dtype=torch.int64).to(dev)
        self.ptr, self.words = self.desc.data_ptr(), len(words)

    def matches(self, opp_cols: Cols) -> bool:
        return len(opp_cols) == len(self.refs) and all(
            d is rd() and v is rv() for (d, v), (rd, rv) in zip(opp_cols, self.refs))


class RingPlan:
    """K10's host side for one ring's buffers: the ring's fields, checked
    once; the count's scratch, which the kernel leaves zeros: the int32
    ticket of its last block and the int32 row totals it adds the rows'
    chunk counts into (grown with the batch); and per set of ring columns
    and own-column dtypes the write's :class:`WriteDesc`.  The plan holds
    the ring's tensors weakly: a cached plan keeps no ring alive, and one
    whose tensors are gone (a regrown ring) no longer matches."""

    def __init__(self, ring: Ring):
        self.b1 = _check_ring(ring, RING_FIELDS)
        self.refs = [weakref.ref(ring[f]) for f in RING_FIELDS]
        self.match_ptrs = [ring[f].data_ptr() for f in ("ts", "krepr", "kval", "live")]
        self.seq_ptr, self.matched_ptr = ring["seq"].data_ptr(), ring["matched"].data_ptr()
        self.device = ring["ts"].device
        self.ticket = torch.zeros(1, dtype=torch.int32, device=self.device)
        self.ticket_ptr = self.ticket.data_ptr()
        self.totals = torch.zeros(0, dtype=torch.int32, device=self.device)
        self._descs: Dict[tuple, WriteDesc] = {}

    def row_totals(self, n: int) -> int:
        """The pointer of at least ``n`` zeroed int32 row totals."""
        if self.totals.shape[0] < n:
            self.totals = torch.zeros(max(n, 2 * self.totals.shape[0]), dtype=torch.int32,
                                      device=self.device)
        return self.totals.data_ptr()

    def matches(self, ring: Ring) -> bool:
        return all(ring[f] is r() for f, r in zip(RING_FIELDS, self.refs))

    def write_desc(self, opp_cols: Cols, own_dtypes) -> WriteDesc:
        key = (tuple((id(d), id(v)) for d, v in opp_cols), own_dtypes)
        desc = self._descs.get(key)
        if desc is None or not desc.matches(opp_cols):
            for d, v in opp_cols:
                _expect(d, d.dtype, (self.b1,))
                _expect(v, torch.bool, (self.b1,))
            if len(opp_cols) > 32:
                raise ValueError("more than 32 buffered columns")
            if len(self._descs) >= 8:
                self._descs.clear()
            desc = self._descs[key] = WriteDesc(opp_cols, own_dtypes, self.device)
        return desc


_RING_PLANS: Dict[tuple, RingPlan] = {}
_RING_PLAN_CACHE_SIZE = 64


def ring_plan(ring: Ring) -> RingPlan:
    """K10's host side for a ring, built and checked once per set of ring
    buffers and cached: a regrow (``_regrow_ring``, ``_grow_ss``) that
    replaces the ring's tensors gets a new one."""
    key = tuple(id(ring[f]) for f in RING_FIELDS)
    plan = _RING_PLANS.get(key)
    if plan is not None and plan.matches(ring):
        return plan
    plan = RingPlan(ring)
    if key not in _RING_PLANS and len(_RING_PLANS) >= _RING_PLAN_CACHE_SIZE:
        _RING_PLANS.pop(next(iter(_RING_PLANS)))
    _RING_PLANS[key] = plan
    return plan


# ------------------------------------------------------ K11: ss_insert
def ss_insert_prologue_plain(row_valid, ts, active, row_matched, ring: Ring, max_ts, smax, cursor,
                             *, pad_side: bool, deferred: bool, swin: int, grace: int,
                             retention: int) -> Dict[str, torch.Tensor]:
    """Plain twin of K11's prologue — see :func:`ss_insert_prologue`."""
    n = ts.shape[0]
    B = ring["ts"].shape[0] - 1
    vts = torch.where(row_valid, ts, torch.full_like(ts, INT64_MIN))
    cm = torch.cummax(vts, 0).values
    cm_global = torch.maximum(cm, max_ts)
    cm_side = torch.maximum(cm, smax)
    pad = torch.zeros(n, dtype=torch.bool, device=ts.device)
    if pad_side:
        pad = active & ~row_matched
        if deferred:  # the row's window closed before it arrived
            pad = pad & (ts + swin + grace < cm_global)
    admitted = active & (ts >= cm_side - retention) if deferred else active.clone()
    cnt = torch.cumsum(admitted.to(torch.int64), 0)
    seqs = cursor + cnt - 1
    tgt = torch.where(admitted, seqs % B, torch.full_like(seqs, B)).to(torch.int32)
    batch_max = vts.max()
    new_max = torch.maximum(max_ts, batch_max)
    new_smax = torch.maximum(smax, batch_max)
    own_ts = ring["ts"]
    unexpired = (own_ts + retention >= new_smax) if deferred else (own_ts + swin + grace >= new_max)
    t = tgt.long()
    lost = (admitted & ring["live"][t] & unexpired[t]).sum()
    out_rows = (~admitted).nonzero()
    dump_row = out_rows[-1, 0] if out_rows.numel() else torch.tensor(-1, device=ts.device)
    scal = torch.stack([lost, cnt[-1], new_max, new_smax, dump_row.to(torch.int64)])
    return {"pad": pad, "admitted": admitted, "seqs": seqs, "tgt": tgt, "scal": scal}


def ss_insert_prologue(row_valid: torch.Tensor, ts: torch.Tensor, active: torch.Tensor,
                       row_matched: torch.Tensor, ring: Ring, max_ts: torch.Tensor,
                       smax: torch.Tensor, cursor: torch.Tensor, *, pad_side: bool,
                       deferred: bool, swin: int, grace: int, retention: int) -> Dict[str, torch.Tensor]:
    """K11, prologue mode (replaces the running maxima, the pad and
    admission masks, the sequence numbers and targets and ``ss_lost`` of
    ``runtime/lowering.py:_trace_ss_step``), over one batch of rows of a
    side against that side's own ``ring``:

    * ``cm_global`` and ``cm_side``: the running max of ``ts`` over
      ``row_valid`` rows, seeded with ``max_ts`` and the side's ``smax``;
    * ``pad``: on a padding side (``pad_side``), an active row with no
      match (``row_matched``, from K10's count) pads now; in deferred
      (GRACE) mode only if ``ts + swin + grace < cm_global``;
    * ``admitted``: active rows (deferred mode: with ``ts >= cm_side -
      retention``); ``seqs = cursor + cumsum(admitted) - 1``; ``tgt`` is
      ``seqs mod B`` for an admitted row, else the dump entry ``B``;
    * ``scal`` int64[5]: the rows' overwrite loss (admitted rows whose
      target entry is live and not expired against the new clocks), the
      admissions, the new ``max_ts``, the new ``smax`` and the highest row
      not admitted (-1 when none).

    Writes no state."""
    if not ts.is_cuda:
        return ss_insert_prologue_plain(row_valid, ts, active, row_matched, ring, max_ts, smax,
                                        cursor, pad_side=pad_side, deferred=deferred, swin=swin,
                                        grace=grace, retention=retention)
    n = ts.shape[0]
    b1 = _check_ring(ring, ("ts", "live"))
    _check_rows(n, ts=ts, row_valid=row_valid, active=active, row_matched=row_matched)
    for s in (max_ts, smax, cursor):
        _expect(s, torch.int64, ())
    dev = ts.device
    out = {"pad": torch.empty(n, dtype=torch.bool, device=dev),
           "admitted": torch.empty(n, dtype=torch.bool, device=dev),
           "seqs": torch.empty(n, dtype=torch.int64, device=dev),
           "tgt": torch.empty(n, dtype=torch.int32, device=dev),
           "scal": torch.empty(5, dtype=torch.int64, device=dev)}
    fn = cuda.lib("ss_insert", "ksql_ss_insert_prologue")
    cuda.check("ss_insert", fn(
        row_valid.data_ptr(), ts.data_ptr(), active.data_ptr(), row_matched.data_ptr(), n,
        ring["ts"].data_ptr(), ring["live"].data_ptr(), b1 - 1, max_ts.data_ptr(),
        smax.data_ptr(), cursor.data_ptr(), int(pad_side), int(deferred), swin, grace,
        retention, out["pad"].data_ptr(), out["admitted"].data_ptr(), out["seqs"].data_ptr(),
        out["tgt"].data_ptr(), out["scal"].data_ptr(), _stream(dev),
    ))
    ss_insert.launches += 1
    ss_insert.mode_launches["prologue"] += 1
    return out


def ss_insert_plain(ring: Ring, ring_cols: Cols, pro, ts, krepr, kvalid, row_matched, cols: Cols,
                    max_ts, smax, cursor) -> None:
    """Plain twin of K11's write — see :func:`ss_insert`."""
    B = ring["ts"].shape[0] - 1
    rows = pro["admitted"].nonzero().squeeze(1)
    tgt = pro["tgt"].long()[rows]
    dump = int(pro["scal"][4])
    fields = [(ring["ts"], ts), (ring["krepr"], krepr), (ring["kval"], kvalid),
              (ring["seq"], pro["seqs"]), (ring["matched"], row_matched | pro["pad"])]
    for (v, m), (d, dv) in zip(ring_cols, cols):
        fields += [(v, d.to(v.dtype)), (m, dv)]
    for dst, src in fields:
        dst[tgt] = src[rows]
        if dump >= 0:
            dst[B] = src[dump]
    ring["live"][tgt] = True
    ring["live"][B] = False
    cursor += pro["scal"][1]
    max_ts.copy_(pro["scal"][2])
    smax.copy_(pro["scal"][3])


def ss_insert(ring: Ring, ring_cols: Cols, pro: Dict[str, torch.Tensor], ts: torch.Tensor,
              krepr: torch.Tensor, kvalid: torch.Tensor, row_matched: torch.Tensor, cols: Cols,
              max_ts: torch.Tensor, smax: torch.Tensor, cursor: torch.Tensor) -> None:
    """K11, write mode (replaces the ring scatters and the clock updates of
    ``runtime/lowering.py:_trace_ss_step``), in place: each admitted row
    writes ``ts``, ``krepr``, ``kval = kvalid``, ``seq``, ``matched =
    row_matched | pad`` and its columns (``cols``, cast to the ring's
    ``ring_cols`` dtypes) to its target entry and sets it live; the
    highest row not admitted writes the same fields to the dump entry
    ``B`` (the last of the reference's duplicate scatters there), whose
    ``live`` ends False.  ``cursor`` advances by the admissions, and
    ``max_ts``/``smax`` take the prologue's new clocks.  ``pro`` is
    :func:`ss_insert_prologue`'s result on the same batch."""
    if not ts.is_cuda:
        ss_insert_plain(ring, ring_cols, pro, ts, krepr, kvalid, row_matched, cols, max_ts, smax,
                        cursor)
        return
    n = ts.shape[0]
    b1 = _check_ring(ring, RING_FIELDS)
    _check_rows(n, ts=ts, krepr=krepr, kvalid=kvalid, row_matched=row_matched,
                pad=pro["pad"], admitted=pro["admitted"], seqs=pro["seqs"], tgt=pro["tgt"])
    _expect(pro["scal"], torch.int64, (5,))
    for s in (max_ts, smax, cursor):
        _expect(s, torch.int64, ())
    desc: List[int] = []
    keep = []  # the cast columns must outlive the launch below
    for (v, m), (d, dv) in zip(ring_cols, cols):
        _expect(v, v.dtype, (b1,))
        _expect(m, torch.bool, (b1,))
        d = d.to(v.dtype).contiguous()
        _expect(d, v.dtype, (n,))
        _expect(dv, torch.bool, (n,))
        keep.append(d)
        desc += [d.data_ptr(), v.data_ptr(), v.element_size(), dv.data_ptr(), m.data_ptr()]
    fn = cuda.lib("ss_insert", "ksql_ss_insert_write")
    cuda.check("ss_insert", fn(
        ts.data_ptr(), krepr.data_ptr(), kvalid.data_ptr(), row_matched.data_ptr(),
        pro["pad"].data_ptr(), pro["admitted"].data_ptr(), pro["seqs"].data_ptr(),
        pro["tgt"].data_ptr(), pro["scal"].data_ptr(), n, ring["ts"].data_ptr(),
        ring["krepr"].data_ptr(), ring["kval"].data_ptr(), ring["live"].data_ptr(),
        ring["matched"].data_ptr(), ring["seq"].data_ptr(), b1 - 1, cuda.host_i64(desc),
        len(cols), cursor.data_ptr(), max_ts.data_ptr(), smax.data_ptr(), _stream(ts.device),
    ))
    ss_insert.launches += 1
    ss_insert.mode_launches["write"] += 1


ss_insert.launches = 0
ss_insert.mode_launches = {"prologue": 0, "write": 0}


# ------------------------------------------------------ K12: ss_expire
def ss_expire_plain(rings: Dict[str, Ring], cols: Dict[str, Cols], max_ts, smax: Dict[str, torch.Tensor],
                    key_dtypes: Sequence[torch.dtype], *, deferred: bool, pad_sides, after: int,
                    before: int, grace: int, retention: int) -> Dict[str, object]:
    """Plain twin of K12 — see :func:`ss_expire`."""
    emit = {}
    for s, win in (("l", after), ("r", before)):
        r = rings[s]
        live = r["live"].clone()
        closed = live & (r["ts"] + win + grace < max_ts)
        emit[s] = closed & ~r["matched"] if deferred and s in pad_sides else torch.zeros_like(live)
        if deferred:  # a padded entry stays until its own side's retention ends
            r["matched"] |= emit[s]
            r["live"].copy_(live & (r["ts"] + retention >= smax[s]))
        else:
            r["live"].copy_(live & ~closed)
    lr = rings["l"], rings["r"]

    def both(fn):
        return torch.cat([fn(lr[0], "l"), fn(lr[1], "r")])

    out: Dict[str, object] = {
        "mask": torch.cat([emit["l"], emit["r"]]),
        "ts": both(lambda r, s: r["ts"]),
        "ord_b": both(lambda r, s: r["seq"] + (SIDE_RANK_R if s == "r" else 0)),
        "keys": [both(lambda r, s: decode_key64(r["krepr"], dt)) for dt in key_dtypes],
        "key_valid": both(lambda r, s: r["kval"] & emit[s]),
    }
    for s in ("l", "r"):
        lanes = []
        for v, m in cols[s]:
            z, zm = torch.zeros_like(v), torch.zeros_like(m)
            own = (v, m & emit[s])
            lanes.append((torch.cat([own[0], z]), torch.cat([own[1], zm])) if s == "l"
                         else (torch.cat([z, own[0]]), torch.cat([zm, own[1]])))
        out[s] = lanes
    return out


def ss_expire(rings: Dict[str, Ring], cols: Dict[str, Cols], max_ts: torch.Tensor,
              smax: Dict[str, torch.Tensor], key_dtypes: Sequence[torch.dtype], *, deferred: bool,
              pad_sides, after: int, before: int, grace: int, retention: int) -> Dict[str, object]:
    """K12 (replaces ``runtime/lowering.py:_trace_ss_expire``): close, pad
    and evict every entry of both rings at stream time ``max_ts``, in
    place, and write the expiry's emission lanes, left ring's entries
    first (``2 (B + 1)`` lanes).

    An entry is closed when live with ``ts + win + grace < max_ts`` (``win``
    is ``after`` on the left, ``before`` on the right).  In deferred
    (GRACE) mode a closed, unmatched entry of a padding side emits a
    null-padded row and is marked matched, and ``live`` keeps the entries
    within their own side's retention (``ts + retention >= smax``); in
    eager mode nothing emits and closed entries die.  Lanes: ``mask``,
    ``ts``, ``ord_b`` (the side's rank + ``seq``), per key dtype of
    ``key_dtypes`` the entry's key decoded from ``krepr`` (``keys``, valid
    bits ``key_valid = kval & emit``), and per buffered column of each
    side (``cols[s]``, the ring's ``(v, m)``) its value on the side's own
    half and zeros on the other, valid only where the entry emits."""
    if not max_ts.is_cuda:
        return ss_expire_plain(rings, cols, max_ts, smax, key_dtypes, deferred=deferred,
                               pad_sides=pad_sides, after=after, before=before, grace=grace,
                               retention=retention)
    b1 = _check_ring(rings["l"], RING_FIELDS)
    if _check_ring(rings["r"], RING_FIELDS) != b1:
        raise ValueError("ss_expire: the two rings differ in size")
    for s in (max_ts, smax["l"], smax["r"]):
        _expect(s, torch.int64, ())
    if len(key_dtypes) > 16:
        raise ValueError("ss_expire: more than 16 key columns")
    dev = max_ts.device
    nn = 2 * b1
    out: Dict[str, object] = {"mask": torch.empty(nn, dtype=torch.bool, device=dev),
                              "ts": torch.empty(nn, dtype=torch.int64, device=dev),
                              "ord_b": torch.empty(nn, dtype=torch.int64, device=dev),
                              "key_valid": torch.empty(nn, dtype=torch.bool, device=dev)}
    out["keys"] = [torch.empty(nn, dtype=dt, device=dev) for dt in key_dtypes]
    descs = {}
    for s in ("l", "r"):
        descs[s], out[s] = _gather_desc(cols[s], b1, nn, dev)
    key_desc: List[int] = []
    for k in out["keys"]:
        key_desc += [k.data_ptr(), k.element_size()]
    args = []
    for s, win in (("l", after), ("r", before)):
        r = rings[s]
        args += [r[f].data_ptr() for f in RING_FIELDS]
        args += [smax[s].data_ptr(), win, int(deferred and s in pad_sides)]
    fn = cuda.lib("ss_expire")
    cuda.check("ss_expire", fn(
        *args, b1, max_ts.data_ptr(), int(deferred), grace, retention,
        cuda.host_i64(descs["l"]), len(cols["l"]), cuda.host_i64(descs["r"]), len(cols["r"]),
        cuda.host_i64(key_desc), len(key_dtypes), out["mask"].data_ptr(), out["ts"].data_ptr(),
        out["ord_b"].data_ptr(), out["key_valid"].data_ptr(), _stream(dev),
    ))
    ss_expire.launches += 1
    return out


ss_expire.launches = 0

KERNEL_WRAPPERS = (ss_match, ss_insert, ss_expire)
_SIDES = {"l": 0, "r": 1}


def _check_ring(ring: Ring, fields) -> int:
    b1 = ring["ts"].shape[0]
    for f in fields:
        _expect(ring[f], _RING_DTYPES[f], (b1,))
    return b1


def _check_rows(n: int, **cols: torch.Tensor) -> None:
    dtypes = {"krepr": torch.int64, "ts": torch.int64, "seqs": torch.int64, "tgt": torch.int32}
    for name, t in cols.items():
        _expect(t, dtypes.get(name, torch.bool), (n,))


def _gather_desc(cols: Cols, src_len: int, out_len: int, dev):
    """Descriptors of a gather into fresh lanes of ``out_len``: per column
    (data src, data dst, element bytes, valid src, valid dst), and the
    output lanes."""
    desc: List[int] = []
    lanes = []
    if len(cols) > 32:
        raise ValueError("more than 32 buffered columns")
    for d, v in cols:
        _expect(d, d.dtype, (src_len,))
        _expect(v, torch.bool, (src_len,))
        do = torch.empty(out_len, dtype=d.dtype, device=dev)
        vo = torch.empty(out_len, dtype=torch.bool, device=dev)
        lanes.append((do, vo))
        desc += [d.data_ptr(), do.data_ptr(), d.element_size(), v.data_ptr(), vo.data_ptr()]
    return desc, lanes
