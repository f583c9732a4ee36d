"""Host-side image loading and transforms (the port's own copy of
``evoke_tpu/data/transforms.py``; numpy, with PIL for real image files).

The reference's torchvision pipelines: 224 train Resize(256) -> RandomCrop(224)
-> RandomHorizontalFlip; 224 eval Resize((224, 224)); 384 train Resize(448)
-> RandomRotation(5) -> RandomCrop(384); 384 eval Resize(448) ->
CenterCrop(384); ImageNet normalisation. Output is channels-last [H, W, 3]
float32, or uint8 before normalisation with ``output_uint8`` (the device
normalises: ``train/steps.maybe_normalize_images``).

PIL is imported only for files that are not ``.npy``: the synthetic path
(``.npy`` float arrays) needs numpy alone.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np

IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def load_image(path: str, image_dir: str = ""):
    full = os.path.join(image_dir, path) if image_dir else path
    if full.endswith(".npy"):
        return np.load(full)  # synthetic: already [H, W, 3] float32
    from PIL import Image

    return Image.open(full).convert("RGB")


def _resize_short(img, size: int):
    from PIL import Image

    w, h = img.size
    if w < h:
        return img.resize((size, int(round(h * size / w))), Image.BILINEAR)
    return img.resize((int(round(w * size / h)), size), Image.BILINEAR)


def _to_float(img) -> np.ndarray:
    if isinstance(img, np.ndarray):
        return img.astype(np.float32)
    return np.asarray(img, np.float32) / 255.0


def _normalize(x: np.ndarray) -> np.ndarray:
    return (x - IMAGENET_MEAN) / IMAGENET_STD


@dataclass
class ImageTransform:
    """train/eval transform for one resolution (224 or 384)."""

    image_size: int = 224
    train: bool = True
    output_uint8: bool = False

    def __call__(self, img, rng: Optional[np.random.Generator] = None) -> np.ndarray:
        if isinstance(img, np.ndarray):
            # synthetic float arrays: centre crop / pad, no PIL
            x = _center_crop_or_pad(img.astype(np.float32), self.image_size)
            if self.output_uint8:
                x = np.clip((x * IMAGENET_STD + IMAGENET_MEAN) * 255.0, 0, 255)
                return x.astype(np.uint8)
            return x
        from PIL import Image

        rng = rng or np.random.default_rng()
        s = self.image_size
        if self.train:
            if s == 224:
                img = _resize_short(img, 256)
                img = _random_crop(img, s, rng)
                if rng.random() < 0.5:
                    img = img.transpose(Image.FLIP_LEFT_RIGHT)
            else:
                img = _resize_short(img, 448)
                img = img.rotate(float(rng.uniform(-5.0, 5.0)), Image.BILINEAR)
                img = _random_crop(img, s, rng)
        elif s == 224:
            img = img.resize((s, s), Image.BILINEAR)
        else:
            img = _center_crop(_resize_short(img, 448), s)
        if self.output_uint8:
            return np.asarray(img, np.uint8)
        return _normalize(_to_float(img))


def _random_crop(img, size: int, rng: np.random.Generator):
    from PIL import Image

    w, h = img.size
    if w < size or h < size:
        img = img.resize((max(w, size), max(h, size)), Image.BILINEAR)
        w, h = img.size
    x = int(rng.integers(0, w - size + 1))
    y = int(rng.integers(0, h - size + 1))
    return img.crop((x, y, x + size, y + size))


def _center_crop(img, size: int):
    w, h = img.size
    x = (w - size) // 2
    y = (h - size) // 2
    return img.crop((x, y, x + size, y + size))


def _center_crop_or_pad(x: np.ndarray, size: int) -> np.ndarray:
    h, w = x.shape[:2]
    if h == size and w == size:
        return x
    out = np.zeros((size, size, x.shape[2]), np.float32)
    ch, cw = min(h, size), min(w, size)
    oy, ox = (size - ch) // 2, (size - cw) // 2
    sy, sx = (h - ch) // 2, (w - cw) // 2
    out[oy:oy + ch, ox:ox + cw] = x[sy:sy + ch, sx:sx + cw]
    return out


def make_transform(image_size: int, train: bool, output_uint8: bool = False
                   ) -> ImageTransform:
    return ImageTransform(image_size=image_size, train=train, output_uint8=output_uint8)
