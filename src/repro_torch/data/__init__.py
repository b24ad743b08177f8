"""Data substrate: the R-MAT graph generators."""
from . import rmat
