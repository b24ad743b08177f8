from .ops import spgemm_hash, spgemm_hash_symbolic
