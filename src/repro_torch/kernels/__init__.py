"""Hand-written CUDA kernels for Hopper, each beside its plain torch
version (the CPU path) with a launch counter:

  paged_attention.py — fused paged-decode attention (csrc/paged_decode.cu)
  semaphore.py       — Algorithm-5 admission timeline
                       (csrc/semaphore_admission.cu)
  build.py           — nvcc build into build/repro_torch/ + ctypes binding
"""
