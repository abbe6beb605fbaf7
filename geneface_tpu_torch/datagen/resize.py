"""uint8 image resizes without OpenCV or Pillow (host numpy), bit for bit
those two libraries' fixed-point arithmetic, for the two the datagen path
needs:

- :func:`resize_bilinear_u8`: ``cv2.resize(img, (w, h), INTER_LINEAR)``
  (FAN's 256² crop). 11-bit coefficients; the columns' start clamped at the
  edges, the rows' weights not (a border row blends the clamped row with
  itself); the vertical pass rounds as OpenCV's vector path does,
  ``((b0·(S0>>4))>>16 + (b1·(S1>>4))>>16 + 2) >> 2``;
- :func:`resize_crop_bicubic_u8`: Pillow's ``Image.resize(size, BICUBIC)``
  then ``crop(box)`` (Deep3DRecon's alignment). Pillow's separable filter
  (``a = -0.5``, the support widened by the scale on a downscale), 22-bit
  coefficients, the horizontal pass first and rounded to uint8; a crop
  outside the image is zero. Only the rows and columns the crop keeps are
  computed.
"""

from __future__ import annotations

import numpy as np

__all__ = ["resize_bilinear_u8", "resize_crop_bicubic_u8"]

_CV_BITS = 11  # INTER_RESIZE_COEF_BITS
_PIL_BITS = 22  # PRECISION_BITS of Pillow's 8-bit resample


def _cv_axis(in_len: int, out_len: int, clamp: bool) -> tuple:
    """(first source index, second, first weight, second weight), OpenCV's."""
    one = np.float32(1 << _CV_BITS)
    f = ((np.arange(out_len) + 0.5) * (in_len / out_len) - 0.5).astype(np.float32)
    s = np.floor(f).astype(np.int64)
    f = f - s.astype(np.float32)
    if clamp:
        low, high = s < 0, s >= in_len - 1
        f[low | high] = 0
        s[low], s[high] = 0, in_len - 1
    c0 = np.round((np.float32(1) - f) * one).astype(np.int64)
    c1 = np.round(f * one).astype(np.int64)
    return np.clip(s, 0, in_len - 1), np.clip(s + 1, 0, in_len - 1), c0, c1


def resize_bilinear_u8(img: np.ndarray, size: tuple) -> np.ndarray:
    """uint8 [H, W, C] → [h, w, C], ``size = (w, h)`` as OpenCV takes it."""
    H, W = img.shape[:2]
    w, h = size
    x0, x1, a0, a1 = _cv_axis(W, w, clamp=True)
    y0, y1, b0, b1 = _cv_axis(H, h, clamp=False)
    im = np.asarray(img, np.int64)
    rows = im[:, x0] * a0[None, :, None] + im[:, x1] * a1[None, :, None]
    b0, b1 = b0[:, None, None], b1[:, None, None]
    v = (((b0 * (rows[y0] >> 4)) >> 16) + ((b1 * (rows[y1] >> 4)) >> 16) + 2) >> 2
    return np.clip(v, 0, 255).astype(np.uint8)


def _bicubic(x: np.ndarray) -> np.ndarray:
    a = -0.5
    x = np.abs(x)
    return np.where(x < 1.0, ((a + 2.0) * x - (a + 3.0)) * x * x + 1,
                    np.where(x < 2.0, (((x - 5) * x + 8) * x - 4) * a, 0.0))


def _pil_coeffs(in_size: int, out_size: int, outs: np.ndarray) -> tuple:
    """(first tap, taps, fixed-point weights [len(outs), ksize]) of the
    output pixels ``outs``, as Pillow's ``precompute_coeffs`` and
    ``normalize_coeffs_8bpc`` give them."""
    scale = in_size / out_size
    fs = max(scale, 1.0)
    support = 2.0 * fs
    ksize = int(np.ceil(support)) * 2 + 1
    first = np.zeros(len(outs), np.int64)
    taps = np.zeros(len(outs), np.int64)
    kk = np.zeros((len(outs), ksize), np.float64)
    for i, xx in enumerate(outs):
        center = (xx + 0.5) * scale
        xmin = max(int(center - support + 0.5), 0)
        xmax = min(int(center + support + 0.5), in_size) - xmin
        wts = _bicubic((np.arange(xmax) + xmin - center + 0.5) * (1.0 / fs))
        total = wts.sum()
        if total != 0.0:
            wts = wts / total
        kk[i, :xmax] = wts
        first[i], taps[i] = xmin, xmax
    fixed = np.where(kk < 0, np.trunc(-0.5 + kk * (1 << _PIL_BITS)),
                     np.trunc(0.5 + kk * (1 << _PIL_BITS)))
    return first, taps, fixed.astype(np.int64)


def _pil_pass(img: np.ndarray, first, taps, kk, axis: int) -> np.ndarray:
    img = np.moveaxis(img, axis, 0)
    ksize = kk.shape[1]
    valid = np.arange(ksize)[None] < taps[:, None]
    idx = np.where(valid, first[:, None] + np.arange(ksize)[None], 0)
    kk = np.where(valid, kk, 0)
    acc = np.full((len(first),) + img.shape[1:], 1 << (_PIL_BITS - 1), np.int64)
    bcast = (-1,) + (1,) * (img.ndim - 1)
    for j in range(ksize):
        acc += img[idx[:, j]] * kk[:, j].reshape(bcast)
    return np.moveaxis(np.clip(acc >> _PIL_BITS, 0, 255), 0, axis)


def resize_crop_bicubic_u8(img: np.ndarray, size: tuple, box: tuple) -> np.ndarray:
    """uint8 [H, W, C] resized to ``size = (w, h)``, then cropped to ``box =
    (left, upper, right, lower)`` → [lower - upper, right - left, C]."""
    H, W, C = img.shape
    w, h = size
    left, up, right, low = box
    out = np.zeros((low - up, right - left, C), np.uint8)
    cols = np.arange(max(left, 0), min(right, w))
    rows = np.arange(max(up, 0), min(low, h))
    if not len(cols) or not len(rows):
        return out
    im = np.asarray(img, np.int64)
    if h != H:
        first, taps, kk = _pil_coeffs(H, h, rows)
        src = np.arange(first.min(), (first + taps).max())  # the rows the crop reads
        im = im[src]
        first = first - src[0]
    if w != W:
        im = _pil_pass(im, *_pil_coeffs(W, w, cols), axis=1)
    else:
        im = im[:, cols]
    im = _pil_pass(im, first, taps, kk, axis=0) if h != H else im[rows]
    out[rows[0] - up: rows[-1] + 1 - up, cols[0] - left: cols[-1] + 1 - left] = im
    return out
