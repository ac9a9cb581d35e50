"""Benchmark twins of the JAX package's ``benchmarks/`` (kernelbench,
membench, primitives, servebench, hostbench and the run entry point;
not roofline_report), runnable as modules:

    python -m repro_torch.benchmarks.kernelbench [--device cpu] [--out F]
    python -m repro_torch.benchmarks.membench
    python -m repro_torch.benchmarks.primitives [--smoke | --alloc-sweep]
        [--device cpu] [--out F] [--alloc-out F]
    python -m repro_torch.benchmarks.servebench [--device cpu] [--smoke]
    python -m repro_torch.benchmarks.hostbench [--threads 8] [--ops 300]
    python -m repro_torch.benchmarks.run [--fast] [--section NAME]
"""
