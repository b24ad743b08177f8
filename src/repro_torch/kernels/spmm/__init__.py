from .ops import spmm_kernel
