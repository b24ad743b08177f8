"""Hand-written CUDA kernels for Hopper (sm_90a), built at first use.

  spgemm_hash -- paper C2/C3: hash + vectorized-probe SpGEMM (CSR)

The other kernels of ``repro.kernels`` are not ported yet (ROADMAP.md,
Queue 2).
"""
