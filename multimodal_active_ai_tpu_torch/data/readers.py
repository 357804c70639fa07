"""Dataset catalogs and shard bookkeeping.

The port's own copy of ``multimodal_active_ai_tpu/data/readers.py``, the
host side of the reference's DALI readers: ``ops.FileReader`` (the ImageNet
folder layout, ``NVIDIA_DALI_Pipelines.py:604-610``), ``ops.COCOReader``
(``:34-42``) and ``compute_shard_size`` (``:647-657``) with DALI's
``pad_last_batch`` semantics: the last batch of a shard is filled by
repeating the final sample, so every shard yields full batches of one
shape. Pure Python and numpy; a test holds every function against the JAX
package's.
"""

from __future__ import annotations

import json
import math
import os
from typing import Sequence

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".JPEG", ".JPG", ".PNG")


def list_image_folder(root: str) -> tuple[list[str], list[int], list[str]]:
    """ImageNet-style ``root/class_x/img.JPEG`` catalog → (files, labels, classes).

    Class indices follow sorted class-directory order, the convention shared
    by DALI's FileReader and torchvision ImageFolder.
    """
    classes = sorted(d for d in os.listdir(root)
                     if os.path.isdir(os.path.join(root, d)))
    files, labels = [], []
    for idx, cls in enumerate(classes):
        cdir = os.path.join(root, cls)
        for name in sorted(os.listdir(cdir)):
            if name.endswith(IMG_EXTENSIONS):
                files.append(os.path.join(cdir, name))
                labels.append(idx)
    return files, labels, classes


def list_coco_images(file_root: str, annotations_file: str | None = None,
                     with_boxes: bool = False):
    """COCO image catalog (``ops.COCOReader`` file side, ``NVIDIA_DALI_Pipelines.py:34``).

    The SimCLR pretraining path consumes only the images (bboxes/labels are
    brought but unused, ``Contrastive_Learning.py:592-593``), so by default
    this returns the image file list — from the annotations JSON when given
    (preserving the reader's annotation-driven ordering) else a directory
    listing.

    ``with_boxes=True`` surfaces the full COCOReader triple: ``(files,
    boxes, box_labels)`` with per-image float32 ``(K, 4)`` boxes in
    normalized **ltrb** (the reference reader's ``ratio=True, ltrb=True``,
    ``NVIDIA_DALI_Pipelines.py:39-40``) and ``(K,)`` int32 category ids.
    """
    if annotations_file and os.path.isfile(annotations_file):
        import numpy as np

        with open(annotations_file) as f:
            ann = json.load(f)
        files = [os.path.join(file_root, im["file_name"])
                 for im in ann["images"]]
        if not with_boxes:
            return files
        dims = {im["id"]: (float(im["width"]), float(im["height"]))
                for im in ann["images"]}
        per_image: dict = {im["id"]: ([], []) for im in ann["images"]}
        for a in ann.get("annotations", []):
            if "bbox" not in a or a["image_id"] not in per_image:
                continue
            w, h = dims[a["image_id"]]
            x, y, bw, bh = a["bbox"]  # COCO xywh pixels -> normalized ltrb
            per_image[a["image_id"]][0].append(
                [x / w, y / h, (x + bw) / w, (y + bh) / h])
            per_image[a["image_id"]][1].append(int(a.get("category_id", 0)))
        boxes = [np.asarray(per_image[im["id"]][0], np.float32).reshape(-1, 4)
                 for im in ann["images"]]
        labels = [np.asarray(per_image[im["id"]][1], np.int32)
                  for im in ann["images"]]
        return files, boxes, labels
    files = [os.path.join(file_root, n) for n in sorted(os.listdir(file_root))
             if n.endswith(IMG_EXTENSIONS)]
    if not with_boxes:
        return files
    import numpy as np

    empty = np.zeros((0, 4), np.float32)
    return files, [empty] * len(files), \
        [np.zeros((0,), np.int32)] * len(files)


def bb_hflip(boxes_ltrb):
    """Horizontal flip of normalized ltrb boxes: the ``ops.BbFlip`` half of
    the reference's bbox-consistent random flip
    (``NVIDIA_DALI_Pipelines.py:51,56-64``): ``l' = 1-r, r' = 1-l``."""
    import numpy as np

    b = np.asarray(boxes_ltrb, np.float32)
    out = b.copy()
    out[..., 0] = 1.0 - b[..., 2]
    out[..., 2] = 1.0 - b[..., 0]
    return out


def compute_shard_size(epoch_size: int, shard_id: int, num_shards: int,
                       batch_size: int, pad_last_batch: bool = True) -> int:
    """Per-shard example count, reference ``NVIDIA_DALI_Pipelines.py:647-657``.

    With ``pad_last_batch`` DALI pads the epoch so every shard sees whole
    batches: ``epoch_size_padded = ceil(epoch/num_shards)·num_shards``, then
    shard boundaries are the floor-divided prefix as in the reference.
    """
    if pad_last_batch:
        padded = math.ceil(epoch_size / num_shards) * num_shards
    else:
        padded = epoch_size
    beg = math.floor(shard_id * padded / num_shards)
    end = math.floor((shard_id + 1) * padded / num_shards)
    return end - beg


def shard_files(files: Sequence, shard_id: int, num_shards: int) -> list:
    """Contiguous shard slice of the catalog (DALI sharding:
    ``shard_id/num_shards`` contiguous ranges, padded by repeating the last
    element to the padded shard size)."""
    n = len(files)
    padded = math.ceil(n / num_shards) * num_shards
    beg = math.floor(shard_id * padded / num_shards)
    end = math.floor((shard_id + 1) * padded / num_shards)
    out = [files[min(i, n - 1)] for i in range(beg, min(end, n))]
    want = end - beg
    while len(out) < want and out:
        out.append(out[-1])
    return out
