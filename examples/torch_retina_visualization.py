#!/usr/bin/env python
"""Visual check of the port's foveated retina (notebook parity).

The port's twin of ``examples/retina_visualization.py`` (the reference's
``SimCLR/NVIDIA DALI/NVIDIA DALI.ipynb``): the 5-level foveation pyramid of
one image at one fixation (the full canvas and the 4 crops, and their 30×30
resizes; ``ops/retina.foveated_pyramid``), the COCO bbox overlay (with the
reference reader's bbox-consistent horizontal flip,
``NVIDIA_DALI_Pipelines.py:56-64``) when annotations are given, saved as
contact sheets where PIL is installed. Works on any image file or a
generated test pattern, on ``--device cuda`` (default) or ``--device cpu``::

    python examples/torch_retina_visualization.py [IMAGE] [--fix-x 0.3 --fix-y 0.7]
    python examples/torch_retina_visualization.py COCO_IMG --annotations FILE [--flip]
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

from multimodal_active_ai_tpu_torch.data.readers import bb_hflip, list_coco_images  # noqa: E402
from multimodal_active_ai_tpu_torch.device import resolve_device  # noqa: E402
from multimodal_active_ai_tpu_torch.ops import retina  # noqa: E402


def load_image(path: str | None, size: int = 640) -> np.ndarray:
    if path:
        from PIL import Image

        with Image.open(path) as im:
            return np.asarray(im.convert("RGB").resize((size, size)), np.uint8)
    # generated test pattern: radial gradient + grid lines
    y, x = np.mgrid[0:size, 0:size].astype(np.float32)
    r = np.sqrt((y - size / 2) ** 2 + (x - size / 2) ** 2) / (size / 2)
    img = np.stack([255 * (1 - r), 128 + 0 * r, 255 * r], -1)
    img[::40] = 255
    img[:, ::40] = 0
    return np.clip(img, 0, 255).astype(np.uint8)


def draw_boxes(img: np.ndarray, boxes_ltrb: np.ndarray,
               color=(255, 32, 32), thickness: int = 3) -> np.ndarray:
    """Burn normalized-ltrb rectangles into an RGB canvas (the notebook's
    bbox overlay)."""
    out = img.copy()
    s = img.shape[0]
    c = np.asarray(color, np.uint8)
    for l, t, r, b in np.asarray(boxes_ltrb, np.float32).reshape(-1, 4):
        x0, y0 = int(l * s), int(t * s)
        x1, y1 = int(r * s), int(b * s)
        x0, x1 = sorted((max(0, min(x0, s - 1)), max(0, min(x1, s - 1))))
        y0, y1 = sorted((max(0, min(y0, s - 1)), max(0, min(y1, s - 1))))
        th = thickness
        out[y0:y0 + th, x0:x1 + 1] = c
        out[max(y1 - th + 1, 0):y1 + 1, x0:x1 + 1] = c
        out[y0:y1 + 1, x0:x0 + th] = c
        out[y0:y1 + 1, max(x1 - th + 1, 0):x1 + 1] = c
    return out


def boxes_for_image(image_path: str, annotations_file: str):
    """The image's normalized-ltrb boxes from a COCO annotations JSON."""
    root = os.path.dirname(os.path.abspath(image_path))
    files, boxes, labels = list_coco_images(root, annotations_file, with_boxes=True)
    want = os.path.basename(image_path)
    for f, bx, lb in zip(files, boxes, labels):
        if os.path.basename(f) == want:
            return bx, lb
    return np.zeros((0, 4), np.float32), np.zeros((0,), np.int32)


def save_png(array: np.ndarray, path: str, what: str) -> bool:
    try:
        from PIL import Image
    except ImportError:
        print(f"(PIL is not installed: {what} not saved)")
        return False
    Image.fromarray(array).save(path)
    return True


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("image", nargs="?", default=None)
    ap.add_argument("--fix-x", type=float, default=0.3)
    ap.add_argument("--fix-y", type=float, default=0.7)
    ap.add_argument("--angle", type=float, default=15.0)
    ap.add_argument("--out", default="retina_pyramid.png")
    ap.add_argument("--annotations", default=None,
                    help="COCO annotations JSON: render the bbox overlay")
    ap.add_argument("--flip", action="store_true",
                    help="horizontal flip (image + bbox-consistent BbFlip)")
    ap.add_argument("--device", default="cuda", help="'cuda' (default) or 'cpu'")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    canvas = load_image(args.image)
    if args.annotations:
        boxes, box_labels = boxes_for_image(args.image, args.annotations)
        shown = canvas
        if args.flip:  # image flip + BbFlip, NVIDIA_DALI_Pipelines.py:56-64
            shown = np.ascontiguousarray(canvas[:, ::-1])
            boxes = bb_hflip(boxes)
        overlay_out = os.path.splitext(args.out)[0] + "_boxes.png"
        if save_png(draw_boxes(shown, boxes), overlay_out, "bbox overlay"):
            print(f"saved bbox overlay ({len(boxes)} boxes, labels "
                  f"{sorted(set(int(x) for x in box_labels))}) to {overlay_out}")

    img = torch.from_numpy(canvas).to(device)
    crops, resizes = retina.foveated_pyramid(
        img, torch.tensor([args.fix_y, args.fix_x], device=device),
        torch.tensor(args.angle, device=device), retina.RetinaConfig())
    print("pyramid crops:", [tuple(c.shape) for c in crops])
    print("glimpse resizes:", [tuple(r.shape) for r in resizes])

    # contact sheet: the 30x30 resizes side by side, upscaled for visibility
    tiles = [F.interpolate(r.permute(2, 0, 1)[None], size=(120, 120), mode="nearest")[0]
             .permute(1, 2, 0) for r in resizes]
    sheet = torch.cat(tiles, dim=1).clamp(0, 255).to(torch.uint8).cpu().numpy()
    if save_png(sheet, args.out, "contact sheet"):
        print(f"saved pyramid contact sheet to {args.out}")
    return {"crops": crops, "resizes": resizes, "sheet": sheet}


if __name__ == "__main__":
    main()
