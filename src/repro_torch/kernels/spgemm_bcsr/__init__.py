from .ops import spgemm_bcsr
