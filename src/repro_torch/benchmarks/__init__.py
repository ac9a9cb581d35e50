"""Benchmark twins of the JAX package's ``benchmarks/`` (kernelbench,
the sync-library part of primitives), runnable as modules:

    python -m repro_torch.benchmarks.kernelbench [--device cpu] [--out F]
    python -m repro_torch.benchmarks.primitives [--device cpu] [--out F]
"""
