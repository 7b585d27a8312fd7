"""RGB-D training augmentation: colour jitter, a random rescale and a centre
crop (numpy on the host, no ``cv2``).

The port's counterpart of the JAX package's ``data/augmentation.py``
(reference data_readers/augmentation.py). The colour jitter follows
torchvision's ColorJitter (brightness, contrast and saturation 0.25, hue
0.4/π of the circle, grayscale with p = 0.1), one draw per clip. The
random draws come in the JAX augmentor's order (b, c, s, h, the grayscale
draw, the scale), so one seed gives the same clip.

Where the JAX augmentor calls ``cv2``, this module computes the same
functions itself:

* the hue shift goes through ``cv2.cvtColor``'s float HSV: H in degrees
  [0, 360), S and V in [0, 1] (:func:`rgb_to_hsv`, :func:`hsv_to_rgb`);
* the images are rescaled by ``cv2.resize(..., INTER_LINEAR)``'s function
  on float32: half-pixel centres, the edge pixel replicated, no
  antialiasing (:func:`resize_linear`);
* the inverse depths as ``INTER_NEAREST``: source index
  floor(x · (1 / (dst/src))) in double, clamped to src − 1
  (:func:`resize_nearest`).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

_EPS = np.float32(np.finfo(np.float32).eps)  # cv2's FLT_EPSILON


def _rgb_to_gray(images: np.ndarray) -> np.ndarray:
    w = np.array([0.299, 0.587, 0.114], np.float32)
    return (images @ w)[..., None]


def rgb_to_hsv(rgb: np.ndarray) -> np.ndarray:
    """float32 RGB in [0, 1] → HSV with H in degrees [0, 360), S and V in
    [0, 1] (``cv2.COLOR_RGB2HSV`` on float32)."""
    rgb = np.asarray(rgb, np.float32)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    v = np.maximum(np.maximum(r, g), b)
    vmin = np.minimum(np.minimum(r, g), b)
    diff = v - vmin
    s = diff / (np.abs(v) + _EPS)
    k = np.float32(60.0) / (diff + _EPS)
    h = np.where(v == r, (g - b) * k, np.where(v == g, (b - r) * k + np.float32(120.0),
                                                (r - g) * k + np.float32(240.0)))
    h = np.where(h < 0, h + np.float32(360.0), h)
    return np.stack([h, s, v], -1).astype(np.float32)


# the (b, g, r) picks from (v, p, q, t) per hue sector (cv2's HSV2RGB)
_SECTORS = np.array([[1, 3, 0], [1, 0, 2], [3, 0, 1], [0, 2, 1], [0, 1, 3], [2, 1, 0]])


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    """HSV (H in degrees) → float32 RGB (``cv2.COLOR_HSV2RGB`` on float32)."""
    hsv = np.asarray(hsv, np.float32)
    h, s, v = hsv[..., 0], hsv[..., 1], hsv[..., 2]
    h = np.fmod(h * (np.float32(6.0) / np.float32(360.0)), np.float32(6.0))
    h = np.where(h < 0, h + np.float32(6.0), h)
    sector = np.floor(h).astype(np.int64)
    h = h - sector.astype(np.float32)
    wrap = (sector < 0) | (sector >= 6)
    sector = np.where(wrap, 0, sector)
    h = np.where(wrap, np.float32(0.0), h)
    one = np.float32(1.0)
    tab = np.stack([v, v * (one - s), v * (one - s * h), v * (one - s * (one - h))], -1)
    pick = _SECTORS[sector]  # [..., 3]: b, g, r
    bgr = np.take_along_axis(tab, pick, axis=-1)
    rgb = bgr[..., ::-1]
    gray = (s == 0)[..., None]
    return np.where(gray, v[..., None], rgb).astype(np.float32)


def _linear_taps(src: int, dst: int):
    """INTER_LINEAR's source taps along one axis, in double: (i0, i1, w0, w1)
    with the source coordinate (x + 0.5)·src/dst − 0.5, the edge pixel
    replicated."""
    f = (np.arange(dst) + 0.5) * (src / dst) - 0.5
    i0 = np.floor(f).astype(np.int64)
    f = f - i0
    edge = (i0 < 0) | (i0 >= src - 1)
    i0 = np.clip(i0, 0, src - 1)
    f = np.where(edge, 0.0, f)
    return i0, np.minimum(i0 + 1, src - 1), 1.0 - f, f


def resize_linear(image: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    """Bilinear resize of a float32 [H, W, ...] array to (h, w), the function
    of ``cv2.resize(image, (w, h), interpolation=cv2.INTER_LINEAR)``: along
    x, then along y, in double, rounded once to float32 (cv2 differs from
    it by a few float32 ulps, by the order of its own arithmetic)."""
    image = np.asarray(image, np.float64)
    H, W = image.shape[:2]
    h, w = size_hw
    x0, x1, a0, a1 = _linear_taps(W, w)
    y0, y1, b0, b1 = _linear_taps(H, h)
    shape_x = (1, w) + (1,) * (image.ndim - 2)
    rows = image[:, x0] * a0.reshape(shape_x) + image[:, x1] * a1.reshape(shape_x)
    shape_y = (h, 1) + (1,) * (image.ndim - 2)
    return (rows[y0] * b0.reshape(shape_y) + rows[y1] * b1.reshape(shape_y)).astype(np.float32)


def _nearest_index(src: int, dst: int) -> np.ndarray:
    inv = 1.0 / (dst / src)
    return np.minimum(np.floor(np.arange(dst) * inv).astype(np.int64), src - 1)


def resize_nearest(image: np.ndarray, size_hw: Tuple[int, int]) -> np.ndarray:
    """Nearest-neighbour resize to (h, w), as
    ``cv2.resize(image, (w, h), interpolation=cv2.INTER_NEAREST)``."""
    h, w = size_hw
    return image[_nearest_index(image.shape[0], h)][:, _nearest_index(image.shape[1], w)]


class RGBDAugmentor:
    def __init__(self, crop_size: Tuple[int, int] = (384, 512), seed: int = 0):
        self.crop_size = tuple(crop_size)
        self.max_scale = 0.25
        self.rng = np.random.default_rng(seed)

    def color_transform(self, images: np.ndarray) -> np.ndarray:
        """images: [N, H, W, 3] RGB float32 0-255; one jitter per clip."""
        r = self.rng
        x = images / 255.0

        # brightness, contrast, saturation factors in [0.75, 1.25]; the hue
        # shift as a fraction of the circle
        b = r.uniform(0.75, 1.25)
        c = r.uniform(0.75, 1.25)
        s = r.uniform(0.75, 1.25)
        h = r.uniform(-0.4 / np.pi, 0.4 / np.pi)

        x = np.clip(x * b, 0, 1)
        mean = x.mean(axis=(1, 2, 3), keepdims=True)
        x = np.clip((x - mean) * c + mean, 0, 1)
        gray = _rgb_to_gray(x)
        x = np.clip((x - gray) * s + gray, 0, 1)

        if abs(h) > 1e-6:
            hsv = rgb_to_hsv(x)
            hsv[..., 0] = (hsv[..., 0] + h * 360.0) % 360.0
            x = hsv_to_rgb(hsv)

        if r.random() < 0.1:
            x = np.repeat(_rgb_to_gray(x), 3, axis=-1)

        return (255.0 * x).astype(np.float32)

    def spatial_transform(self, images, depths, poses, intrinsics):
        """Random log-uniform rescale and centre crop (reference
        augmentation.py:20-47)."""
        n, ht, wd = images.shape[:3]
        ch, cw = self.crop_size
        min_scale = np.log2(max((ch + 1) / ht, (cw + 1) / wd))
        scale = 2.0 ** self.rng.uniform(min_scale, self.max_scale)

        h1, w1 = int(round(ht * scale)), int(round(wd * scale))
        images = np.stack([resize_linear(im, (h1, w1)) for im in images])
        depths = np.stack([resize_nearest(d, (h1, w1)) for d in depths])
        intrinsics = intrinsics * scale

        y0 = (h1 - ch) // 2
        x0 = (w1 - cw) // 2
        intrinsics = intrinsics - np.array([0.0, 0.0, x0, y0], np.float32)
        images = images[:, y0 : y0 + ch, x0 : x0 + cw]
        depths = depths[:, y0 : y0 + ch, x0 : x0 + cw]
        return images, poses, depths, intrinsics

    def __call__(self, images, poses, depths, intrinsics):
        """images [N, H, W, 3] RGB, depths = inverse depths [N, H, W]."""
        images = self.color_transform(images)
        return self.spatial_transform(images, depths, poses, intrinsics)
