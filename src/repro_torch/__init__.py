"""PyTorch / CUDA port of the ``repro`` package for one NVIDIA H100.

The JAX package (``src/repro``) is the reference; this package mirrors
its layout (configs, models, kernels, core, sync, serve, launch) and
imports neither ``jax`` nor anything of ``repro``. The serving main
path — paged, chunked-prefill, bucketed ``SlotServeEngine`` on
``qwen3-14b`` — runs its decode attention and its Algorithm-5
admission planner as hand-written CUDA kernels (``csrc/``), built with
``nvcc`` at first use. Entry points run on ``cuda`` unless the caller
asks for ``device="cpu"``.
"""
