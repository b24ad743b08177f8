"""Mamba-2 SSD chunk scan: the hand-written CUDA kernel, its wrapper and
the plain (chunked einsum) version."""
from .ops import ssd_chunk
