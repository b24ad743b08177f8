"""Hand-written CUDA kernels for Hopper (sm_90a), built at first use.

  spgemm_hash -- paper C2/C3: hash + vectorized-probe SpGEMM (CSR)
  spgemm_pb   -- propagation-blocking scatter/merge pair (low CF)

The other kernels of ``repro.kernels`` are not ported yet (ROADMAP.md,
Queue 2).
"""
