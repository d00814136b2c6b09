"""Image resize on the host (numpy), to what OpenCV's ``cv2.resize``
computes on float images (``modules/imgproc/src/resize.cpp``), with no
dependency on OpenCV and no 8-bit detour: values above 1 stay as they are.

- ``resize_area`` is ``INTER_AREA``: a block mean for integer factors, the
  pixel-area weights of ``computeResizeAreaTab`` for fractional ones, and
  OpenCV's bilinear variant where an axis grows.
- ``resize_linear`` is ``INTER_LINEAR``: half-pixel centres, the border
  pixels replicated.

Both take the image as float32 and resample the width first and the
height second. ``resize_linear`` computes what OpenCV's x86 builds
compute, which resize float images through Intel IPP: weights rounded
once from float64 and ``a0 + (a1 - a0) * w`` in one fused multiply-add
(OpenCV's own ``INTER_LINEAR`` code, without IPP, is up to ~4e-5
relative off). ``resize_area`` follows OpenCV's own loops: bit for bit
for fractional factors and where the image grows, to an ulp for integer
factors (whose block sums OpenCV orders by size and channel count). Sizes
are given as OpenCV's ``dsize``, (width, height). A 2-D image stays 2-D,
and an (H, W, 1) image comes back (H, W), as from OpenCV.
"""
import math

import numpy as np


def _linear_taps(n_src, n_dst, area_mode):
    """(source ids (n_dst, 2), weights (n_dst, 2) float32) of OpenCV's
    bilinear resize along one axis: half-pixel centres, the weights
    rounded once from float64 (IPP's). ``area_mode``: the variant that
    INTER_AREA uses where the image grows, whose fractions OpenCV rounds to
    float32 before it takes them apart."""
    inv_scale = n_dst / n_src
    scale = 1.0 / inv_scale
    dx = np.arange(n_dst, dtype=np.float64)
    if area_mode:
        sx = np.floor(dx * scale)
        fx = ((dx + 1) - (sx + 1) * inv_scale).astype(np.float32)
        fx = np.where(fx <= 0, np.float32(0), fx - np.floor(fx))
    else:
        fx = (dx + 0.5) * scale - 0.5
        sx = np.floor(fx)
        fx = (fx - sx).astype(np.float32)
    sx = sx.astype(np.int64)
    fx = np.where((sx < 0) | (sx >= n_src - 1), np.float32(0), fx)
    sx = np.clip(sx, 0, n_src - 1)
    ids = np.stack([sx, np.minimum(sx + 1, n_src - 1)], -1)
    return ids, np.stack([np.float32(1) - fx, fx], -1).astype(np.float32)


def _area_taps(n_src, n_dst):
    """(source ids (n_dst, K), weights (n_dst, K) float32) of OpenCV's
    ``computeResizeAreaTab`` (the image shrinks along this axis): each
    destination pixel averages the source pixels its cell covers, the
    partial ones weighted by their covered share. Unused slots have weight
    0."""
    scale = 1.0 / (n_dst / n_src)
    taps = []
    for dx in range(n_dst):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, n_src - fsx1)
        sx1, sx2 = math.ceil(fsx1), math.floor(fsx2)
        sx2 = min(sx2, n_src - 1)
        sx1 = min(sx1, sx2)
        row = []
        if sx1 - fsx1 > 1e-3:
            row.append((sx1 - 1, (sx1 - fsx1) / cell))
        row += [(sx, 1.0 / cell) for sx in range(sx1, sx2)]
        if fsx2 - sx2 > 1e-3:
            row.append((sx2, min(min(fsx2 - sx2, 1.0), cell) / cell))
        taps.append(row)
    K = max(len(r) for r in taps)
    ids = np.zeros((n_dst, K), np.int64)
    w = np.zeros((n_dst, K), np.float32)
    for dx, row in enumerate(taps):
        for k, (sx, a) in enumerate(row):
            ids[dx, k], w[dx, k] = sx, a
    return ids, w


def _apply(img, axis, ids, w):
    """Sum over k of ``w[:, k] * img[ids[:, k]]`` along ``axis``, term by
    term from zero, in float32 (OpenCV's own loops)."""
    shape = [1] * img.ndim
    shape[axis] = -1
    out = np.zeros_like(np.take(img, ids[:, 0], axis=axis))
    for k in range(ids.shape[1]):
        out += np.take(img, ids[:, k], axis=axis) * w[:, k].reshape(shape)
    return out


def _lerp(img, axis, ids, w):
    """``a0 + (a1 - a0) * w1`` along ``axis`` with one rounding, as IPP's
    fused multiply-add computes it (the float32 product is exact in
    float64)."""
    shape = [1] * img.ndim
    shape[axis] = -1
    a0 = np.take(img, ids[:, 0], axis=axis)
    a1 = np.take(img, ids[:, 1], axis=axis)
    w1 = w[:, 1].astype(np.float64).reshape(shape)
    return ((a1 - a0).astype(np.float64) * w1 + a0).astype(np.float32)


def _prepare(img):
    img = np.asarray(img, np.float32)
    if img.ndim == 3 and img.shape[2] == 1:
        img = img[..., 0]
    return img


def _resample(img, wh, taps, combine):
    """The width resampled first, then the height."""
    w, h = wh
    H, W = img.shape[:2]
    return combine(combine(img, 1, *taps(W, w)), 0, *taps(H, h))


def resize_area(img, wh):
    """``cv2.resize(img, wh, interpolation=cv2.INTER_AREA)`` on a float
    image."""
    img = _prepare(img)
    w, h = wh
    H, W = img.shape[:2]
    if (W, H) == (w, h):
        return img.copy()
    scale_x, scale_y = 1.0 / (w / W), 1.0 / (h / H)
    if scale_x < 1 or scale_y < 1:
        # OpenCV's area resize shrinks only; elsewhere its bilinear variant
        return _resample(img, wh,
                         lambda n, m: _linear_taps(n, m, area_mode=True),
                         _apply)
    ix, iy = round(scale_x), round(scale_y)
    if (abs(scale_x - ix) < np.finfo(np.float64).eps
            and abs(scale_y - iy) < np.finfo(np.float64).eps):
        # integer factors: each block's sum, row by row in groups of four
        # as OpenCV's loop adds them, times 1 / area
        cells = [img[a:h * iy:iy, b:w * ix:ix]
                 for a in range(iy) for b in range(ix)]
        acc = np.zeros_like(cells[0])
        for k in range(0, len(cells) - len(cells) % 4, 4):
            acc += ((cells[k] + cells[k + 1]) + cells[k + 2]) + cells[k + 3]
        for cell in cells[len(cells) - len(cells) % 4:]:
            acc += cell
        return acc * np.float32(1.0 / (ix * iy))
    return _resample(img, wh, _area_taps, _apply)


def resize_linear(img, wh):
    """``cv2.resize(img, wh)`` (``INTER_LINEAR``) on a float image."""
    img = _prepare(img)
    w, h = wh
    H, W = img.shape[:2]
    if (W, H) == (w, h):
        return img.copy()
    return _resample(img, wh,
                     lambda n, m: _linear_taps(n, m, area_mode=False), _lerp)
