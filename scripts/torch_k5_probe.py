"""Time design variants of K5 (sliced_fold) on the card.

Builds copies of ``csrc/sliced_fold.cu`` with text edits (one ``nvcc``
each, all started together) and times each as chip_smoke times a kernel
(device ms from torch.profiler, call ms from CUDA events) at the shapes of
``scripts/torch_slice_times.py``'s ``k5`` group.  Variants that leave a
part out are timing probes only: their results are not held against the
twin (``kept`` is, and so is every variant marked exact):

* ``kept``: the source as it is (128-thread blocks);
* ``256 threads a block``: the rows on fewer SMs;
* ``no warp combine``: one atomic a row and component;
* ``two launches``: the reset, then the fold as a second launch, a kernel
  boundary in place of the grid barrier;
* ``no dump inits``: only stale cells are reset (timing only);
* ``no barrier``: no grid barrier between the phases (timing only);
* ``no fold``: the reset phase alone (timing only).

    python scripts/torch_k5_probe.py

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

_DUMP = "    const int64_t cell = (stale ? r.eff : capacity) * ring + r.pos;\n"
_SYNC = "  grid.sync();\n"
_SHARED = "    const bool shared = __any_sync(0xffffffffu, r.act && (peers & (peers - 1)) != 0);\n"
_FOLD = "  // ---- fold\n"
_THREADS = "constexpr int kThreads = 128;"
_LAUNCH = ("  void* params[] = {&c, &s, &ws, &a, &n, &capacity, &ring, &width, &sid, &sl, &d, &rl};\n"
           "  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(sliced_fold_kernel), dim3(blocks),\n"
           "                                    dim3(kThreads), params, 0, static_cast<cudaStream_t>(stream));\n")
#: the phases as two launches: the reset, then the fold (a kernel boundary
#: in place of the grid barrier)
_TWO = [
    ("    int32_t* __restrict__ ring_last) {", "    int32_t* __restrict__ ring_last, int phase) {"),
    ("  Row kept{};\n  for (int64_t base = warp0; base < n; base += stride) {",
     "  Row kept{};\n  for (int64_t base = warp0; phase != 1 && base < n; base += stride) {"),
    (_SYNC, "  if (phase == 0) return;\n"),
    ("    Row r = base == warp0 ? kept : Row{};\n    if (base != warp0 && in) r = row_of(",
     "    Row r{};\n    if (in) r = row_of("),
    (_LAUNCH, "".join(f"  sliced_fold_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(\n"
                      f"      c, s, ws, a, n, capacity, ring, width, sid, sl, d, rl, {phase});\n" for phase in (0, 1))
     + "  err = cudaSuccess;\n"),
]
#: (name, text edits of the source, whether its result is held to the twin)
K5_VARIANTS = [
    ("kept", [], True),
    ("256 threads a block", [(_THREADS, "constexpr int kThreads = 256;")], True),
    ("no warp combine", [(_SHARED, "    const bool shared = false;\n")], True),
    ("two launches", _TWO, True),
    ("no dump inits", [(_DUMP, "    if (!stale) continue;\n    const int64_t cell = r.eff * ring + r.pos;\n")], False),
    ("no barrier", [(_SYNC, "")], False),
    ("no fold", [(_FOLD, "  return;\n")], False),
]


def k5_variants(cs, torch, out_dir, seed, report):
    """K5_VARIANTS at the shapes of ``torch_slice_times.k5_shapes``."""
    from ksql_tpu_torch.ops import cuda
    from ksql_tpu_torch.ops import slicing

    spec = importlib.util.spec_from_file_location("k3p", os.path.join(HERE, "scripts", "torch_k3_probe.py"))
    k3p = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(k3p)
    src = (cuda.SRC_DIR / "sliced_fold.cu").read_text()
    paths = [k3p._write(os.path.join(out_dir, f"k5_v{i}.cu"), k3p._edited(src, edits))
             for i, (_name, edits, _exact) in enumerate(K5_VARIANTS)]
    libs = k3p.build_all(paths, str(cuda.SRC_DIR))
    from ksql_tpu_torch.ops import hash_store as hs

    dev = torch.device(cs.DEVICE)
    rng = np.random.default_rng(seed + 10)
    n = cs.HOP_ROWS
    rng.zipf(1.3, n)  # phase 2h's K1 draws come first
    rng.random((1, n))
    rng.integers(0, 31 * cs.HOUR_MS, n)
    cases = [("sliced 2h", *cs.make_sliced_case(hs, rng, cs.HOP_STORE, cs.HOP_RING, n))]
    cases.append(("sliced phase 7 batch", *cs.make_sliced_case(hs, np.random.default_rng(seed + 12), cs.HOP_STORE,
                                                               cs.HOP_RING, cs.LONG_ROWS)))
    for (name, _edits, exact), lib in zip(K5_VARIANTS, libs):
        cuda._LIBS["ksql_sliced_fold"] = k3p._bind(lib, "sliced_fold", "ksql_sliced_fold")
        for shape, layout, store, rows in cases:
            if exact:
                _sk, rec, what = cs.check_sliced_fold(torch, layout, store, rows, dev)
            else:
                base = {k: torch.from_numpy(v).to(dev) for k, v in store.items()}
                work = cs._clone(base)
                scratch = slicing.init_slice_scratch(layout.capacity, layout.components[0].width,
                                                     cs.HOUR_MS // cs.SLICE_MS, dev)
                t = {k: torch.from_numpy(rows[k]).to(dev) for k in ("slots", "wstart", "active")}
                contribs = [torch.from_numpy(c).to(dev) for c in rows["contribs"]]

                def call():
                    slicing.sliced_fold(work, scratch, layout, t["slots"], t["wstart"], contribs, t["active"],
                                        cs.SLICE_MS)

                def reset():
                    cs._restore(work, base)
                    scratch["ring_last"].fill_(-1)

                ms = cs.kernel_device_ms(torch, "sliced_fold", call, reset)
                rec = dict(ms=ms, call_ms=cs.time_events(torch, call, reset), plain_ms=0.0, bound_ms=0.0)
                what = "timing only"
            report("sliced_fold", name, shape, rec, what)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device: this script times kernels on the card", file=sys.stderr)
        return 1
    import chip_smoke as cs

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    out_dir = os.path.join(HERE, "build", "probe")
    records = []

    def report(kernel, variant, shape, rec, what):
        records.append(dict(rec, kernel=kernel, variant=variant, shape=shape, what=what))
        print(f"[{kernel} {variant} {shape}] {what}: device {rec['ms']:.4f} ms, call {rec['call_ms']:.4f} ms")

    k5_variants(cs, torch, out_dir, args.seed, report)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "records": records}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
