"""The benches and measurement tools of the port, one module each, each the
counterpart of a tool in the JAX package's ``tools/``:

    python -m fea_tpu_torch.bench.tube           # tools/tube_bench.py
    python -m fea_tpu_torch.bench.curv           # tools/curv_bench.py
    python -m fea_tpu_torch.bench.canon          # tools/canon_bench.py
    python -m fea_tpu_torch.bench.arbitrary      # tools/arbitrary_bench.py
    python -m fea_tpu_torch.bench.many           # tools/many_bench.py
    python -m fea_tpu_torch.bench.unstructured   # tools/unstructured_bench.py
    python -m fea_tpu_torch.bench.scipy_compare  # tools/scipy_compare.py
    python -m fea_tpu_torch.bench.spmv           # tools/spmv_bench.py
    python -m fea_tpu_torch.bench.microbench     # tools/t_microbench.py
    python -m fea_tpu_torch.bench.profile        # tools/t_profile.py
    python -m fea_tpu_torch.bench.prewarm        # tools/prewarm.py

Each takes its tool's flags and defaults, with ``--device`` (the CUDA
card when omitted; raises without one) in place of ``--cpu``, has a
``main(argv) -> dict`` that returns its record, and prints that record
as one JSON line, exiting non-zero when the run failed; a module's
docstring names the tool's flags and keys it leaves out, and why. The
first six are ``bench_torch.py``'s families. ``scenes`` builds every scene
of the benchmark, ``_family`` holds the stage harness (counterpart of
``tools/_family_util.py``), the host's independent checks and the card's
timers.
"""
