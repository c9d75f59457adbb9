"""3D cache (port of gen3c_tpu/cache)."""

from gen3c_tpu_torch.cache.cache3d import Cache3DBase, Cache3DBuffer

__all__ = ["Cache3DBase", "Cache3DBuffer"]
