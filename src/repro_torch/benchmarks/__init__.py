"""Benchmark twins of the JAX package's ``benchmarks/`` (kernelbench, the
sync-library part of primitives, servebench, hostbench and the run entry
point), runnable as modules:

    python -m repro_torch.benchmarks.kernelbench [--device cpu] [--out F]
    python -m repro_torch.benchmarks.primitives [--device cpu] [--out F]
    python -m repro_torch.benchmarks.servebench [--device cpu] [--smoke]
    python -m repro_torch.benchmarks.hostbench [--threads 8] [--ops 300]
    python -m repro_torch.benchmarks.run [--fast] [--section NAME]
"""
