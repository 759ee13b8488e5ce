"""The port's host prep (``vistaocr_tpu_torch/data/transforms.py``, numpy
only) byte-equal to the JAX package's PIL-based transforms on the CPU:
``to_grayscale`` on seeded RGB, RGBA and grayscale arrays and PIL images;
``height_normalize`` and ``normalize_line`` (grayscale, polarity, PIL's
BILINEAR resize) on up- and down-scaling, the ``max_width`` clamp, a
width of 1 and a height of 1; host deskew: PIL's ``rotate(BILINEAR)``
replica at seeded angles in [-5, 5] with both ``expand`` values and both
fill colours (and PIL's fast paths), the default resize (BICUBIC for
mode ``L``) replica, and 200 seeded skewed lines through
``estimate_skew``, ``deskew`` and ``normalize_line(do_deskew=True)``
against the JAX package's PIL path."""

import numpy as np
import pytest
from PIL import Image

from vistaocr_tpu.data import transforms as jax_tf

from vistaocr_tpu_torch.data import transforms

RNG_SEEDS = [0, 1, 2]


def _colour(seed, shape):
    rng = np.random.default_rng(seed)
    img = rng.integers(0, 256, shape, np.uint8)
    if seed % 2:  # flat regions and hard edges, as text lines have
        img = (img // 128 * 255).astype(np.uint8)
    return img


@pytest.mark.parametrize("seed", RNG_SEEDS)
@pytest.mark.parametrize("channels", [None, 3, 4])
def test_to_grayscale_arrays_byte_equal(seed, channels):
    shape = (23, 57) if channels is None else (23, 57, channels)
    img = _colour(seed, shape)
    ours = transforms.to_grayscale(img)
    ref = jax_tf.to_grayscale(img)
    assert ours.dtype == np.uint8 and ours.shape == (23, 57)
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "LA", "P", "1"])
def test_to_grayscale_pil_images_byte_equal(mode):
    img = Image.fromarray(_colour(5, (19, 31, 4)), "RGBA").convert(mode)
    np.testing.assert_array_equal(transforms.to_grayscale(img),
                                  jax_tf.to_grayscale(img))


def test_one_channel_array_is_its_channel():
    """[H, W, 1]: the JAX function's docstring takes it, but PIL's
    ``fromarray`` has no mode for a one-channel 3-D array and raises; the
    port returns the channel, which is what the JAX function gives for the
    same pixels as [H, W]."""
    img = _colour(3, (11, 13, 1))
    with pytest.raises(TypeError):
        jax_tf.to_grayscale(img)
    np.testing.assert_array_equal(transforms.to_grayscale(img),
                                  jax_tf.to_grayscale(img[:, :, 0]))


def test_colour_array_of_other_dtype_raises_as_pil_does():
    img = np.zeros((4, 5, 3), np.float32)
    with pytest.raises(TypeError):
        jax_tf.to_grayscale(img)
    with pytest.raises(TypeError):
        transforms.to_grayscale(img)


# (h, w, height, max_width): down-scaling by small and large factors,
# up-scaling, the max_width clamp (also below the aspect width), a width
# of 1 before and after, a height of 1, and a line already at the height
RESIZE_CASES = [(64, 300, 32, None), (200, 911, 32, None),
                (17, 45, 32, None), (7, 3, 32, None), (48, 1000, 32, 512),
                (40, 77, 32, 20), (90, 1, 32, None), (32, 1, 32, None),
                (1, 40, 32, None), (5, 600, 32, 1), (32, 128, 32, None),
                (33, 2048, 48, 2048)]


@pytest.mark.parametrize("case", RESIZE_CASES, ids=str)
@pytest.mark.parametrize("seed", [0, 1])
def test_height_normalize_byte_equal(case, seed):
    h, w, height, max_width = case
    img = _colour(seed, (h, w))
    ours = transforms.height_normalize(img, height, max_width=max_width)
    ref = jax_tf.height_normalize(img, height, max_width=max_width)
    assert ours.dtype == np.uint8 and ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("case", RESIZE_CASES[:6], ids=str)
@pytest.mark.parametrize("channels", [None, 3, 4])
def test_normalize_line_byte_equal(case, channels):
    h, w, height, max_width = case
    shape = (h, w) if channels is None else (h, w, channels)
    for seed in (2, 3):
        img = _colour(seed, shape)
        if seed == 3:  # a photographic negative: the polarity flip
            img = (255 - img // 2).astype(np.uint8) // 3
        for item in (img, Image.fromarray(img)):
            ours = transforms.normalize_line(item, height,
                                             max_width=max_width)
            ref = jax_tf.normalize_line(item, height, max_width=max_width)
            np.testing.assert_array_equal(ours, ref)


def test_deskew_is_refused_by_name():
    # host deskew is ported: the line that was refused runs, byte-equal
    img = _colour(0, (40, 90))
    np.testing.assert_array_equal(
        transforms.normalize_line(img, 32, do_deskew=True),
        jax_tf.normalize_line(img, 32, do_deskew=True))


# --- host deskew: PIL's rotate and default (BICUBIC) resize in numpy ---------
@pytest.mark.parametrize("expand", [False, True])
@pytest.mark.parametrize("fill", [0, 255])
def test_rotate_matches_pil(expand, fill):
    rng = np.random.default_rng(11 + 2 * expand + (fill > 0))
    for _ in range(40):
        h, w = int(rng.integers(1, 70)), int(rng.integers(1, 400))
        img = rng.integers(0, 256, (h, w), np.uint8)
        angle = float(rng.uniform(-5, 5))
        ref = np.asarray(Image.fromarray(img).rotate(
            angle, resample=Image.BILINEAR, expand=expand, fillcolor=fill))
        np.testing.assert_array_equal(
            transforms._rotate(img, angle, expand=expand, fillcolor=fill),
            ref)
    img = rng.integers(0, 256, (9, 13), np.uint8)
    for angle in (0.0, 90.0, 180.0, 270.0, -90.0):  # PIL's fast paths
        np.testing.assert_array_equal(
            transforms._rotate(img, angle, expand=expand, fillcolor=fill),
            np.asarray(Image.fromarray(img).rotate(
                angle, resample=Image.BILINEAR, expand=expand,
                fillcolor=fill)))


def test_default_resize_is_bicubic_and_matches_pil():
    rng = np.random.default_rng(12)
    for _ in range(60):
        h, w = int(rng.integers(1, 70)), int(rng.integers(1, 1300))
        img = rng.integers(0, 256, (h, w), np.uint8)
        size = (int(rng.integers(1, 600)), int(rng.integers(1, 70)))
        ref = np.asarray(Image.fromarray(img).resize(size))
        np.testing.assert_array_equal(
            transforms._resize(img, *size, "bicubic"), ref)
        np.testing.assert_array_equal(ref, np.asarray(
            Image.fromarray(img).resize(size, resample=Image.BICUBIC)))


def _skewed_lines(seed, n):
    """Seeded ink-on-paper lines (h 4-64, w 4-1200) with strokes along a
    random slope: both early returns (h or w < 8) and the w > 512
    subsample are hit."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        h, w = int(rng.integers(4, 65)), int(rng.integers(4, 1201))
        img = np.full((h, w), 255, np.uint8)
        slope = rng.uniform(-0.08, 0.08)
        for _ in range(max(2, w // 10)):
            x = int(rng.integers(0, w))
            y = int(h / 2 + slope * (x - w / 2)
                    + rng.integers(-(h // 4) - 1, h // 4 + 1))
            y = min(max(y, 0), h - 1)
            img[max(0, y - 2):y + 2, x:x + int(rng.integers(1, 6))] = int(
                rng.integers(0, 80))
        out.append(img)
    return out


@pytest.mark.parametrize("part", range(4))
def test_deskew_matches_jax(part):
    lines = _skewed_lines(40 + part, 50)
    sizes = [x.shape for x in lines]
    assert any(min(s) < 8 for s in sizes) and any(s[1] > 512 for s in sizes)
    for img in lines:
        assert transforms.estimate_skew(img) == jax_tf.estimate_skew(img)
        got, ref = transforms.deskew(img), jax_tf.deskew(img)
        assert got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
        np.testing.assert_array_equal(
            transforms.normalize_line(img, 32, do_deskew=True,
                                      max_width=2048),
            jax_tf.normalize_line(img, 32, do_deskew=True, max_width=2048))
