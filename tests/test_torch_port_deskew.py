"""The port's on-device deskew (``ops/deskew.py``) against the JAX
package's on the CPU: ``estimate_skew_tan``, ``shear_deskew`` and
``device_deskew`` on the same skewed lines (ink bands and glyph-like
strokes sheared by known angles, ragged widths, a batch) within 1e-5,
the deskewed images within one uint8 level, the near-zero bin passing
through unchanged, and the estimate recovering the applied skew."""

import math

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from vistaocr_tpu.ops import deskew as jax_deskew

from vistaocr_tpu_torch.ops import deskew

torch.set_num_threads(2)


def _shear_np(img, tan_theta, fill=255):
    """numpy oracle: vertical shear y_src = y + (x-cx)*tan, bilinear."""
    H, W = img.shape
    out = np.full((H, W), fill, np.float32)
    cx = (W - 1) / 2.0
    for y in range(H):
        for xx in range(W):
            src = y + (xx - cx) * tan_theta
            if 0.0 <= src <= H - 1.0:
                lo = int(np.floor(src))
                hi = min(lo + 1, H - 1)
                f = src - lo
                out[y, xx] = img[lo, xx] * (1 - f) + img[hi, xx] * f
    return np.clip(np.round(out), 0, 255).astype(np.uint8)


def _skewed_batch(degrees, H=32, W=160, seed=0):
    """Lines of glyph-like strokes on a band, each sheared by its angle;
    ragged widths (the right part of the narrower lines is paper)."""
    rng = np.random.default_rng(seed)
    imgs, widths = [], []
    for i, deg in enumerate(degrees):
        w = W - 24 * (i % 3)
        img = np.full((H, W), 255, np.uint8)
        img[12:20, 6: w - 6] = rng.integers(0, 60, (8, w - 12))
        for _ in range(w // 12):
            x = int(rng.integers(6, w - 8))
            img[8:24, x: x + 2] = int(rng.integers(0, 90))
        img = _shear_np(img, math.tan(math.radians(deg)))
        img[:, w:] = 255
        imgs.append(img)
        widths.append(w)
    return np.stack(imgs), np.array(widths, np.int32)


DEGREES = (-3.0, -1.5, 0.0, 0.1, 2.0, 4.0)


def test_estimate_matches_jax_and_recovers_skew():
    images, widths = _skewed_batch(DEGREES)
    want = np.asarray(jax_deskew.estimate_skew_tan(jnp.asarray(images),
                                                   jnp.asarray(widths)))
    got = deskew.estimate_skew_tan(torch.from_numpy(images),
                                   torch.from_numpy(widths))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)
    for est, deg in zip(got.numpy(), DEGREES):
        assert est == pytest.approx(-math.tan(math.radians(deg)),
                                    abs=math.tan(math.radians(0.8)))


@pytest.mark.parametrize("deg", [-4.5, 2.5])
def test_shear_matches_jax(deg):
    rng = np.random.default_rng(3)
    images = rng.integers(0, 256, (3, 32, 64)).astype(np.uint8)
    widths = np.array([64, 50, 7], np.int32)
    tan = np.full((3,), math.tan(math.radians(deg)), np.float32)
    tan[1] *= -0.5
    want = np.asarray(jax_deskew.shear_deskew(
        jnp.asarray(images), jnp.asarray(widths), jnp.asarray(tan)))
    got = deskew.shear_deskew(torch.from_numpy(images),
                              torch.from_numpy(widths), torch.from_numpy(tan))
    assert got.dtype == torch.uint8
    assert np.abs(got.numpy().astype(int) - want.astype(int)).max() <= 1


def test_device_deskew_matches_jax():
    images, widths = _skewed_batch(DEGREES, seed=5)
    out_j, tan_j = jax_deskew.device_deskew(jnp.asarray(images),
                                            jnp.asarray(widths))
    out, tan = deskew.device_deskew(torch.from_numpy(images),
                                    torch.from_numpy(widths))
    np.testing.assert_allclose(tan.numpy(), np.asarray(tan_j), rtol=0,
                               atol=1e-5)
    diff = np.abs(out.numpy().astype(int) - np.asarray(out_j).astype(int))
    assert diff.max() <= 1
    # the near-zero bin is identity
    flat = np.flatnonzero(np.asarray(tan_j) == 0.0)
    assert flat.size >= 1
    np.testing.assert_array_equal(out.numpy()[flat], images[flat])
