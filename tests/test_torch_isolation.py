"""The port stands alone: no JAX, no ksql_tpu, and no silent CPU carry-on.

* No module under ``ksql_tpu_torch/``, and not ``chip_smoke.py``, the
  card-side scripts or the card tests and their cases (``CARD_SIDE``),
  imports ``jax`` or ``ksql_tpu`` (an AST scan of every import
  statement).
* A fresh interpreter that imports the port and runs ``run_plan``, or a
  push registry's taps, on the CPU never loads ``jax``.
* Without ``device=``, the entry points run on CUDA and raise when there is
  no card; ``chip_smoke.py`` exits non-zero without a card, and from a
  directory holding nothing else of the repository, printing no result.
"""

import ast
import os
import shutil
import subprocess
import sys
import textwrap

import pytest
import torch

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), os.pardir))
PKG = os.path.join(ROOT, "ksql_tpu_torch")
FORBIDDEN = ("jax", "jaxlib", "ksql_tpu")


#: the card-side scripts and test helpers, beside the package and chip_smoke.py
CARD_SIDE = ("scripts/torch_store_overflow.py", "scripts/torch_slice_times.py",
             "scripts/torch_k10_k13_probe.py", "scripts/torch_k8_warp_probe.py",
             "scripts/torch_k16_k17_probe.py", "scripts/torch_k3_probe.py", "scripts/torch_k5_probe.py",
             "scripts/torch_k4_k21_probe.py", "scripts/torch_k18_k25_probe.py",
             "tests/torch_kernel_cases.py", "tests/test_torch_kernels_gpu.py")


def _sources():
    out = [os.path.join(ROOT, "chip_smoke.py")] + [os.path.join(ROOT, *p.split("/")) for p in CARD_SIDE]
    for d, _dirs, files in os.walk(PKG):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", _sources(), ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imports(path) if m.split(".")[0] in FORBIDDEN]
    assert not bad, f"{os.path.relpath(path, ROOT)} imports {bad}"


def _run(code, cwd=ROOT):
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT
    return subprocess.run([sys.executable, "-c", textwrap.dedent(code)], cwd=cwd,
                          env=env, capture_output=True, text=True, timeout=300)


def test_run_plan_on_cpu_never_loads_jax():
    r = _run("""
        import json, sys
        from ksql_tpu_torch.runner import run_plan
        from ksql_tpu_torch.runtime.topics import Broker, Record
        plan = json.load(open("ksql_tpu_torch/plans/pv_counts_tumbling.json"))
        b = Broker()
        t = b.create_topic("page_views")
        for i in range(50):
            t.produce(Record(None, json.dumps({"URL": f"/p/{i % 7}", "USER_ID": i, "VIEWTIME": i}), 1000 * i))
        run_plan(plan, b, device="cpu", capacity=16, store_capacity=64)
        out = b.topic("PV_COUNTS").all_records()
        assert len(out) >= 7, len(out)
        loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "ksql_tpu"))
        print("LOADED", loaded)
    """)
    assert r.returncode == 0, r.stderr
    assert "LOADED []" in r.stdout


def test_entry_points_default_to_cuda_and_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is usable")
    import json

    from ksql_tpu_torch.runner import run_plan, start_plan
    from ksql_tpu_torch.runtime.topics import Broker
    from ksql_tpu_torch.state import state_from_numpy

    with open(os.path.join(PKG, "plans", "pv_counts_tumbling.json")) as f:
        plan = json.load(f)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_plan(plan, Broker())
    for name in ("enriched_join.json", "ss_join_grace.json", "pv_sessions.json"):
        with open(os.path.join(PKG, "plans", name)) as f:
            join_plan = json.load(f)
        with pytest.raises(RuntimeError, match="CUDA"):
            start_plan(join_plan, Broker())
    with pytest.raises(RuntimeError, match="CUDA"):
        state_from_numpy({})
    from ksql_tpu_torch.runner import start_push_registry

    with pytest.raises(RuntimeError, match="CUDA"):
        start_push_registry(Broker())


def test_push_taps_on_cpu_never_load_jax():
    r = _run("""
        import json, sys
        from ksql_tpu_torch.runner import start_push_registry
        from ksql_tpu_torch.runtime.topics import Broker, Record
        from ksql_tpu_torch.server.push_session import PushQuerySession
        tmpl = json.load(open("ksql_tpu_torch/plans/tap_mod_page_views.json"))
        b = Broker()
        t = b.create_topic("page_views")
        reg = start_push_registry(b, device="cpu")
        sessions = [PushQuerySession(reg, tmpl), PushQuerySession(reg, tmpl)]
        for i in range(600):
            t.produce(Record(None, json.dumps({"URL": "/p", "USER_ID": i, "VIEWTIME": i}), i))
        rows = [s.poll() for s in sessions]
        assert [len(r) for r in rows] == [3, 3], rows
        assert reg.stats()["residual"]["kernel-evals-total"] == 1
        loaded = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "ksql_tpu"))
        print("LOADED", loaded)
    """)
    assert r.returncode == 0, r.stderr
    assert "LOADED []" in r.stdout


@pytest.mark.parametrize("alone", [False, True], ids=["checkout", "script_alone"])
def test_chip_smoke_fails_without_a_card(alone, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    cwd = ROOT
    if alone:
        shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
        cwd = str(tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
