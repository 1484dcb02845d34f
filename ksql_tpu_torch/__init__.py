"""ksql_tpu_torch — the PyTorch/CUDA port of ksql_tpu for NVIDIA Hopper.

The package mirrors ``ksql_tpu``'s layout and names, imports ``torch`` and
``numpy`` only (never ``jax`` or ``ksql_tpu``), and keeps its own copies of
the host modules it needs.  Its entry point is
:func:`ksql_tpu_torch.runner.run_plan`, which runs a serialized physical
plan (``plan_to_json`` output) against an in-process broker.  Device work
runs on ``cuda`` unless the caller passes ``device="cpu"``.
"""
