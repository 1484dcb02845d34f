"""Time design variants of K3 (fold_and_mark, fold mode) on the card.

Builds copies of ``csrc/fold_and_mark.cu`` with text edits (one ``nvcc``
each, all started together), holds each against its twin (exact; float64
sums to rtol 1e-12) and times it as chip_smoke times a kernel (device ms
from torch.profiler, call ms from CUDA events) at the shapes of
``scripts/torch_slice_times.py``'s ``k3`` group (phase 2's 65,536 rows over
31 hours, uniform URLs, the flagship's own timestamps, the undo shape):

* ``kept``: the source as it is (a warp's rows of one slot folded through
  shared memory, one atomic a group, then a grid barrier and the winners);
* ``no warp combine``: every active row its own group, one atomic a row
  (the parent's fold inside this launch);
* ``two launches``: the kept fold, then the winners pass as a second
  launch instead of a grid barrier.

    python scripts/torch_k3_probe.py

Prints the card's name and power limit, a line a variant and shape, and
one JSON line of the records.  Needs a CUDA device; exits 1 without one.
"""

import argparse
import ctypes
import importlib.util
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)

_PHASE = [
    ("    bool* __restrict__ winners) {\n  __shared__ long long s_vals[kWarps][32];",
     "    bool* __restrict__ winners, int phase) {\n  __shared__ long long s_vals[kWarps][32];"),
    ("  for (int64_t base = warp0; base < n; base += stride) {\n",
     "  for (int64_t base = warp0; phase != 1 && base < n; base += stride) {\n"),
    ("  grid.sync();\n", "  if (phase == 2) grid.sync();\n  if (phase == 0) return;\n"),
    ("  void* params[] = {&c, &s, &a, &n, const_cast<int32_t*>(&cap), &d, &f, &w};",
     "  int both = 2;\n  void* params[] = {&c, &s, &a, &n, const_cast<int32_t*>(&cap), &d, &f, &w, &both};"),
]
_COOP = ("  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(fold_mark_kernel), dim3(blocks),\n"
         "                                    dim3(kThreads), params, 0, static_cast<cudaStream_t>(stream));")
_TWO = ("  fold_mark_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(c, s, a, n, cap, d, f, w, 0);\n"
        "  fold_mark_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(c, s, a, n, cap, d, f, w, 1);\n"
        "  err = cudaSuccess;")
_MATCH = "    const unsigned peers = __match_any_sync(0xffffffffu, s);\n"
#: (name, text edits of the source)
K3_VARIANTS = [
    ("kept", []),
    ("no warp combine", [(_MATCH, "    const unsigned peers = 1u << lane;\n")]),
    ("two launches", _PHASE + [(_COOP, _TWO)]),
]


def _write(path, src):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(src)
    return path


def _edited(src, edits):
    for old, new in edits:
        assert src.count(old) == 1, old
        src = src.replace(old, new)
    return src


def build_all(paths, include):
    """Compile every source path into a shared library, all at once."""
    from ksql_tpu_torch.ops import cuda

    procs = []
    for path in paths:
        so = path[:-3] + ".so"
        cmd = [cuda.nvcc_path(), *cuda.NVCC_FLAGS, "-I", include, "-o", so, path]
        procs.append((subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), so))
    libs = []
    for proc, so in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(log)
        libs.append(ctypes.CDLL(so))
    return libs


def _bind(lib, kernel, entry):
    from ksql_tpu_torch.ops import cuda

    fn = getattr(lib, entry)
    fn.argtypes = cuda.SIGNATURES[kernel][entry]
    fn.restype = ctypes.c_int
    return fn


def k3_variants(cs, torch, out_dir, seed, report):
    """K3_VARIANTS at the fold shapes of ``torch_slice_times.k3_shapes``."""
    from ksql_tpu_torch.ops import cuda

    spec = importlib.util.spec_from_file_location("sts", os.path.join(HERE, "scripts", "torch_slice_times.py"))
    sts = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(sts)
    src = (cuda.SRC_DIR / "fold_and_mark.cu").read_text()
    paths = [_write(os.path.join(out_dir, f"k3_v{i}.cu"), _edited(src, edits))
             for i, (_name, edits) in enumerate(K3_VARIANTS)]
    libs = build_all(paths, str(cuda.SRC_DIR))
    for (name, _edits), lib in zip(K3_VARIANTS, libs):
        cuda._LIBS["ksql_fold_and_mark"] = _bind(lib, "fold_and_mark", "ksql_fold_and_mark")
        for _kernel, shape, rec, what in sts.k3_shapes(cs, torch, seed, folds_only=True):
            report("fold_and_mark", name, shape, rec, what)


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
        print(f"[{kernel} {variant} {shape}] {what}: device {rec['ms']:.4f} ms, call {rec['call_ms']:.4f} ms, "
              f"plain {rec['plain_ms']:.4f} ms, bound {rec['bound_ms']:.6f} ms")

    k3_variants(cs, torch, out_dir, args.seed, report)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "records": records}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
