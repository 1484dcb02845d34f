"""Time design variants of K18 (suppress_close) and K25 (tap_residual) on the card.

Builds copies of ``csrc/suppress_close.cu`` and ``csrc/tap_residual.cu``
with text edits (one ``nvcc`` each, all started together), holds each
against its twin (exact) and times it as chip_smoke times a kernel
(device ms from torch.profiler, call ms from CUDA events) at the shapes of
``scripts/torch_slice_times.py``'s ``k18`` and ``k25`` groups:

* K18 at phase 2f's three shapes (phase 12's 65,536 lanes over 2^20 + 1
  slots, 12h's, 12g's 2^20 lanes): ``kept``; ``two launches`` (born, then
  close, no grid barrier); ``warp dedupe`` (each distinct close a warp's
  round searched by one lane and shuffled to the others); ``no sample``
  (the whole of cm_emit searched in L2, 16 positions a round); a sample
  of 2,048 entries (4,096 kept); ``binary search in the chunk`` (one
  position a round, not 16) and 4 a round; 8 slots a lane (16 kept: more
  warps, each with fewer candidates in turn, but more blocks loading the
  sample); born read before the atomic for every lane, not only for a
  warp's groups of several lanes;
* K25 at phase 2p's 256 lanes x 4,096 rows and 4,096 x 8,192 and its cast
  and case families at 64 x 4,096: ``kept``; ``no fused parameters`` (the
  kept kernel on programs that push a parameter on the stack for the
  binary op after it, as ``build_program`` has it); 2 and 8 rows a thread;
  lane groups of 1 and of up to 64 lanes a block, and a grid of two
  waves of resident blocks (one kept); ``stack in shared memory`` (every
  stack level, not the top two in registers); the registers left to
  ptxas (72 a thread: 7 blocks an SM; 8 kept) and capped for 12 blocks.

    python scripts/torch_k18_k25_probe.py [--groups k18,k25]

Prints the card's name and power limit, a line a variant and shape, and
one JSON line of the records.  Needs a CUDA device; exits 1 without one.
"""

import argparse
import importlib.util
import json
import os
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

_SAMPLE = "constexpr int kSample = 4096;"
#: K18 as two launches, born then close, with no grid barrier
_K18_TWO_LAUNCHES = [
    ("close_slots_kernel(const __grid_constant__ Args a) {",
     "close_slots_kernel(const __grid_constant__ Args a, int phases) {"),
    ("  born_phase(a, &c_min);\n  cg::this_grid().sync();\n  close_phase(a, sample, list, res);\n",
     "  if (phases & 1) born_phase(a, &c_min);\n  if (phases & 2) close_phase(a, sample, list, res);\n"),
    ("  const int64_t born_blocks = (lanes + kThreads - 1) / kThreads;\n",
     "  const int64_t born_blocks = (lanes + kThreads - 1) / kThreads;\n"
     "  close_slots_kernel<<<ksql::blocks_for(born_blocks * kThreads, kThreads), kThreads, 0, st>>>(a, 1);\n"
     "  const int born_err = static_cast<int>(cudaGetLastError());\n"
     "  if (born_err != 0) return born_err;\n"
     "  close_slots_kernel<<<ksql::blocks_for(close_blocks * kThreads, kThreads), kThreads, 0, st>>>(a, 2);\n"
     "  if (born_blocks >= 0) return static_cast<int>(cudaGetLastError());\n"),
]
#: K18's search: the lanes of a warp's round with one close value leave it
#: to their lowest lane, which shuffles the answer to the others
_K18_DEDUPE = [
    ("      int64_t at = 0;\n      const int64_t pos = has ? first_at_or_past(a, sample, ch, close, &at) : a.n;\n",
     "      int64_t at = 0, pos = a.n;\n"
     "      const unsigned on = __ballot_sync(kFull, has);\n"
     "      const unsigned peers = __match_any_sync(kFull, static_cast<unsigned long long>(close)) & on;\n"
     "      const int leader = has ? __ffs(peers) - 1 : lane_id;\n"
     "      if (has && leader == lane_id) pos = first_at_or_past(a, sample, ch, close, &at);\n"
     "      pos = __shfl_sync(kFull, pos, leader);\n"
     "      at = __shfl_sync(kFull, at, leader);\n"),
]
#: K18 with 8 slots a lane: 8-byte vectors of each flag
_K18_EIGHT_SLOTS = [
    ("constexpr int kSlots = 16;", "constexpr int kSlots = 8;"),
    ("    const uint4 v = *reinterpret_cast<const uint4*>(p + s0);\n"
     "    const uint32_t w[4] = {v.x, v.y, v.z, v.w};\n",
     "    const uint2 v = *reinterpret_cast<const uint2*>(p + s0);\n"
     "    const uint32_t w[4] = {v.x, v.y, 0u, 0u};\n"),
    ("    *reinterpret_cast<uint4*>(p + s0) = make_uint4(spread4(bits & 0xFu), spread4((bits >> 4) & 0xFu),\n"
     "                                                   spread4((bits >> 8) & 0xFu), spread4((bits >> 12) & 0xFu));\n",
     "    *reinterpret_cast<uint2*>(p + s0) = make_uint2(spread4(bits & 0xFu), spread4((bits >> 4) & 0xFu));\n"),
]
#: (name, text edits of csrc/suppress_close.cu)
K18_VARIANTS = [
    ("kept", []),
    ("two launches", _K18_TWO_LAUNCHES),
    ("warp dedupe", _K18_DEDUPE),
    ("no sample", [(_SAMPLE, "constexpr int kSample = 1;")]),
    ("sample of 2,048", [(_SAMPLE, "constexpr int kSample = 2048;")]),
    ("binary search in the chunk", [("constexpr int kFan = 16;", "constexpr int kFan = 2;")]),
    ("4 positions a search round", [("constexpr int kFan = 16;", "constexpr int kFan = 4;")]),
    ("8 slots a lane", _K18_EIGHT_SLOTS),
    ("born read first for every lane", [("__popc(peers) == 1 || order", "order")]),
]
_ROWS = "constexpr int kRows = 4;"
_GROUP = "constexpr int kMaxGroup = 16;"
#: K25 with every stack level in shared memory: each instruction reads its
#: top two entries from their levels and writes them back after
_K25_SHARED_STACK = [
    ("    const int d = p.depth[pc];\n    switch (op) {\n",
     "    const int d = p.depth[pc];\n"
     "    if (d >= 1) tb = lv.get(d - 1, t);\n"
     "    if (d >= 2) nb = lv.get(d - 2, s);\n"
     "    switch (op) {\n"),
    ("        if (!fused && d >= 3) nb = lv.get(d - 3, s);\n        break;\n      }\n    }\n  }\n",
     "        if (!fused && d >= 3) nb = lv.get(d - 3, s);\n        break;\n      }\n    }\n"
     "    const int nd = pc + 1 < p.n_instr ? p.depth[pc + 1] : 0;  // the depth after it\n"
     "    if (nd >= 1) lv.put(nd - 1, t, tb);\n"
     "    if (nd >= 2) lv.put(nd - 2, s, nb);\n  }\n"),
    ("  prog.levels = static_cast<int32_t>(depth > 2 ? depth - 2 : 0);",
     "  prog.levels = static_cast<int32_t>(depth);"),
]
#: the K25 variant that runs the kept kernel on programs lowered with no
#: parameter fused into its op (``lower_for_kernel`` with no binary op to
#: fuse into)
_UNFUSED = "no fused parameters"
#: (name, text edits of csrc/tap_residual.cu)
K25_VARIANTS = [
    ("kept", []),
    (_UNFUSED, []),
    ("2 rows a thread", [(_ROWS, "constexpr int kRows = 2;")]),
    ("8 rows a thread", [(_ROWS, "constexpr int kRows = 8;")]),
    ("1 lane a block", [(_GROUP, "constexpr int kMaxGroup = 1;")]),
    ("up to 64 lanes a block", [(_GROUP, "constexpr int kMaxGroup = 64;")]),
    ("a grid of two waves", [("constexpr int kWaves = 1;", "constexpr int kWaves = 2;")]),
    ("stack in shared memory", _K25_SHARED_STACK),
    ("registers unbounded", [("constexpr int kBlocksPerSm = 8;", "constexpr int kBlocksPerSm = 1;")]),
    ("registers for 12 blocks an SM", [("constexpr int kBlocksPerSm = 8;", "constexpr int kBlocksPerSm = 12;")]),
]


def _k3p():
    spec = importlib.util.spec_from_file_location("k3p", os.path.join(HERE, "scripts", "torch_k3_probe.py"))
    k3p = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(k3p)
    return k3p


def _build(k3p, name, variants, out_dir, tag):
    from ksql_tpu_torch.ops import cuda

    src = (cuda.SRC_DIR / f"{name}.cu").read_text()
    paths = [k3p._write(os.path.join(out_dir, f"{tag}_v{i}.cu"), k3p._edited(src, edits))
             for i, (_name, edits) in enumerate(variants)]
    return k3p.build_all(paths, str(cuda.SRC_DIR))


def k18_variants(cs, torch, out_dir, seed, report):
    from ksql_tpu_torch.ops import cuda
    from ksql_tpu_torch.ops import suppress as sup

    libs = _build(_k3p(), "suppress_close", K18_VARIANTS, out_dir, "k18")
    dev = torch.device(cs.DEVICE)
    grace = cs.FINAL_GRACE_MS
    cases = []
    for tag, rows, mode, seed_off, advance in (("12", cs.N_ROWS, "tumbling", 11, cs.FINAL_ADVANCE_MS),
                                              ("12h", cs.HOP_ROWS, "expansion", 12, cs.HOP_ADVANCE_MS),
                                              ("12g", cs.FINAL_GROW_ROWS, "tumbling", 12, cs.HOP_ADVANCE_MS)):
        c = cs.make_suppress_case(torch, np.random.default_rng(seed + seed_off), dev, rows, cs.STORE,
                                  advance=advance)
        ws, act = (c["tws"], c["act_rows"]) if mode == "tumbling" else (c["hws"], c["hact"])
        st = c["store"]
        lanes_act, _c0, cm_emit = sup.suppress_clock_plain(c["ts"], ws, act, c["row_valid"], st["max_ts"],
                                                           st["emit_clock"], cs.HOUR_MS, grace)
        if tag == "12":
            lanes_act = c["act_rows"]
        cases.append((tag, c, c["slots"] if mode == "tumbling" else c["hop_slots"], lanes_act, cm_emit))
    for (name, _edits), lib in zip(K18_VARIANTS, libs):
        cuda._LIBS["ksql_suppress_close"] = _k3p()._bind(lib, "suppress_close", "ksql_suppress_close")
        for tag, c, slots, lanes_act, cm_emit in cases:
            _sk, rec, what, _w = cs._check_suppress_close(torch, c, slots, lanes_act, cm_emit, grace, per_call=None)
            report("suppress_close", name, tag, rec, what)
    cuda._LIBS.pop("ksql_suppress_close", None)


def k25_variants(cs, torch, out_dir, seed, report):
    from ksql_tpu_torch.ops import cuda
    from ksql_tpu_torch.ops import tap_residual as tr

    libs = _build(_k3p(), "tap_residual", K25_VARIANTS, out_dir, "k25")
    dev = torch.device(cs.DEVICE)
    rng = np.random.default_rng(seed + 60)
    corpus = cs.corpus_plans()
    cases = []
    for shape, plans, lanes, rows in [(f"{lanes}x{rows}", cs.mod_plans(lanes), lanes, rows)
                                      for lanes, rows in ((cs.TAP_LANES, cs.TAP_ROWS),
                                                          (cs.TAP_MAX_LANES, cs.TAP_MAX_ROWS))] + \
            [(name, corpus[name], cs.TAP_CORPUS_LANES, cs.TAP_ROWS) for name in ("cast", "case")]:
        group = cs.tap_group(torch, plans, lanes)
        cases.append((shape, group, cs.make_tap_case(torch, rng, dev, group, rows)))
    binary = tr._BINARY
    for (name, _edits), lib in zip(K25_VARIANTS, libs):
        cuda._LIBS["ksql_tap_residual"] = _k3p()._bind(lib, "tap_residual", "ksql_tap_residual")
        tr.lane_masks.scratch.clear()
        tr._BINARY = frozenset() if name == _UNFUSED else binary
        for shape, group, args in cases:
            group._program = None  # lowered again under this variant's rules
            prog, matched = cs._check_tap(torch, tr, group, args, f"{name} {shape}")
            nbytes, ops = cs._tap_bytes_ops(prog, args)
            rec = cs.measure(torch, "tap_residual", lambda prog=prog, args=args: tr.lane_masks(prog, *args),
                             lambda prog=prog, args=args: tr.lane_masks_plain(prog.spec, prog.col_types, *args),
                             nbytes, ops, plain_reps=1, per_call=1)
            report("tap_residual", name, shape, rec, f"{prog.n_instr} instructions, {matched} matches")
    tr._BINARY = binary
    for _shape, group, _args in cases:
        group._program = None
    cuda._LIBS.pop("ksql_tap_residual", None)
    tr.lane_masks.scratch.clear()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--groups", default="k18,k25", help="comma-separated: k18, k25")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this script times kernels on the card", file=sys.stderr)
        return 1
    import chip_smoke as cs

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    out_dir = os.path.join(HERE, "build", "probe")
    os.makedirs(out_dir, exist_ok=True)
    records = []

    def report(kernel, variant, shape, rec, what):
        records.append(dict(rec, kernel=kernel, variant=variant, shape=shape, what=what))
        print(f"[{kernel} {variant} {shape}] {what}: device {rec['ms']:.4f} ms, call {rec['call_ms']:.4f} ms, "
              f"bound {rec['bound_ms']:.5f} ms")

    groups = {"k18": k18_variants, "k25": k25_variants}
    for g in args.groups.split(","):
        groups[g](cs, torch, out_dir, args.seed, report)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "records": records}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
