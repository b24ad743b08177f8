"""Data substrate: the R-MAT graph generators and the Table 2 proxies."""
from . import matrices, rmat
