"""Analysis helpers: the SpGEMM roofline at the H100's rates."""
from . import roofline
