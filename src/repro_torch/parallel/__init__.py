"""Single-device parallel context of the port (meshes are not ported)."""
from .sharding import ParallelCtx, single_device_ctx
