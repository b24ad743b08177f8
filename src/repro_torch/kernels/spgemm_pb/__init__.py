from .ops import pb_merge, pb_scatter, spgemm_pb
