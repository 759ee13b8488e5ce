"""The port's host prep (``vistaocr_tpu_torch/data/transforms.py``, numpy
only) byte-equal to the JAX package's PIL-based transforms on the CPU:
``to_grayscale`` on seeded RGB, RGBA and grayscale arrays and PIL images;
``height_normalize`` and ``normalize_line`` (grayscale, polarity, PIL's
BILINEAR resize) on up- and down-scaling, the ``max_width`` clamp, a
width of 1 and a height of 1; ``do_deskew`` refused by name."""

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
    with pytest.raises(NotImplementedError, match="ROADMAP Queue 1: deskew"):
        transforms.normalize_line(_colour(0, (40, 90)), 32, do_deskew=True)
