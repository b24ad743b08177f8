"""Hand-written CUDA kernels for Hopper (sm_90a), built at first use.

  spgemm_hash -- paper C2/C3: hash + vectorized-probe SpGEMM (CSR)
  spgemm_pb   -- propagation-blocking scatter/merge pair (low CF)
  spgemm_bcsr -- block-row hash SpGEMM over BCSR tiles
  spmm        -- CSR times dense (the BFS frontier stack, section 5.5)
  flash_attention -- GQA attention forward (LM prefill)
  ssd_chunk   -- Mamba-2 SSD chunk scan (SSD prefill)
"""
