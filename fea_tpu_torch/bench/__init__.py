"""The family benches of ``bench_torch.py``, one module a family, each the
counterpart of a tool in the JAX package's ``tools/``:

    python -m fea_tpu_torch.bench.tube        # tools/tube_bench.py
    python -m fea_tpu_torch.bench.curv        # tools/curv_bench.py
    python -m fea_tpu_torch.bench.canon       # tools/canon_bench.py
    python -m fea_tpu_torch.bench.arbitrary   # tools/arbitrary_bench.py

Each takes its tool's flags and defaults, with ``--device`` (the CUDA
card when omitted; raises without one) in place of ``--cpu``, has a
``main(argv) -> dict`` that returns its record, and prints that record
as one JSON line, exiting non-zero when the run failed. ``scenes`` builds
every scene of the benchmark, ``_family`` holds the stage harness
(counterpart of ``tools/_family_util.py``) and the host's independent
check.
"""
