"""Hand-written CUDA kernels for Hopper, each beside its plain torch
version (the CPU path) with a launch counter:

  paged_attention.py — fused paged-decode attention (csrc/paged_decode.cu)
  semaphore.py       — Algorithm-5 admission timeline
                       (csrc/semaphore_admission.cu)
  ticket_lock.py     — Algorithm-3 FA mutex timeline (csrc/ticket_lock.cu)
  xf_barrier.py      — one XF flag-barrier epoch (csrc/xf_barrier.cu)
  membench.py        — the paper's Section-3 memory cells
                       (csrc/membench.cu)
  build.py           — nvcc build into build/repro_torch/ + ctypes binding
"""
