"""Hand-written CUDA kernels for Hopper (sm_90a), built at first use.

  spgemm_hash -- paper C2/C3: hash + vectorized-probe SpGEMM (CSR)
  spgemm_pb   -- propagation-blocking scatter/merge pair (low CF)
  spgemm_bcsr -- block-row hash SpGEMM over BCSR tiles
  spmm        -- CSR times dense (the BFS frontier stack, section 5.5)

The other kernels of ``repro.kernels`` are not ported yet (ROADMAP.md,
Queue 2).
"""
