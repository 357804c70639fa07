"""data of the PyTorch port: the file catalogs and shards (``readers``), the
host loader and its canvas cache (``loader``), the native JPEG decoder
(``native``), the host→device prefetch (``prefetch``) and the synthetic
reader; the exports of the JAX package's ``data/__init__.py``."""

from multimodal_active_ai_tpu_torch.data.readers import (
    compute_shard_size,
    list_coco_images,
    list_image_folder,
    shard_files,
)
from multimodal_active_ai_tpu_torch.data.loader import HostLoader
from multimodal_active_ai_tpu_torch.data.synthetic import SyntheticReader

__all__ = [
    "compute_shard_size",
    "list_coco_images",
    "list_image_folder",
    "shard_files",
    "HostLoader",
    "SyntheticReader",
]
