"""Vector stores: the /stores/{set,get,delete,find} capability
(localai_tpu/stores/). The keys live on the device; a find is one matmul
there and a stable sort."""

from localai_tpu_torch.stores.store import StoreRegistry, VectorStore  # noqa: F401
