"""The port's greedy decode and on-device resize against the JAX package:
greedy ids exact and the packed score column within +-1 (the two
frameworks sum the frame maxima in different orders), the frozen golden
bundle string-exact with its CER/WER (as tests/test_golden.py:29-39), and
resize within 1 uint8 level of the JAX resize."""

import json
import os

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from vistaocr_tpu.decode.greedy import greedy_frames as jax_greedy_frames
from vistaocr_tpu.decode.greedy import (
    greedy_frames_packed as jax_greedy_frames_packed,
)
from vistaocr_tpu.ops import resize as jax_resize
from vistaocr_tpu.text import cer_wer

from vistaocr_tpu_torch.decode import (
    collapse_frames,
    greedy_decode,
    greedy_frames,
    greedy_frames_packed,
)
from vistaocr_tpu_torch.ops import resize
from vistaocr_tpu_torch.text import Alphabet

torch.set_num_threads(2)

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


def _posteriors(seed, B=6, T=40, K=9):
    rng = np.random.default_rng(seed)
    logits = rng.normal(0, 2, (B, T, K)).astype(np.float32)
    logits[:, ::3, 0] += 4.0  # plenty of blanks and repeats
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    frames = rng.integers(0, T + 1, B)
    frames[0] = T
    mask = np.arange(T)[None, :] < frames[:, None]
    return lp.astype(np.float32), mask


class TestGreedy:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_frames_exact(self, seed):
        lp, mask = _posteriors(seed)
        ref = np.asarray(jax_greedy_frames(jnp.asarray(lp), jnp.asarray(mask)))
        ours = greedy_frames(torch.from_numpy(lp), torch.from_numpy(mask))
        assert ours.dtype == torch.int32
        np.testing.assert_array_equal(ours.numpy(), ref)

    @pytest.mark.parametrize("seed", [0, 3])
    def test_packed_ids_exact_score_within_one(self, seed):
        lp, mask = _posteriors(seed, T=200)
        ref = np.asarray(jax_greedy_frames_packed(jnp.asarray(lp),
                                                  jnp.asarray(mask)))
        ours = greedy_frames_packed(torch.from_numpy(lp),
                                    torch.from_numpy(mask)).numpy()
        assert ours.shape == ref.shape and ours.dtype == np.int32
        np.testing.assert_array_equal(ours[:, :-1], ref[:, :-1])
        assert np.abs(ours[:, -1].astype(np.int64) - ref[:, -1]).max() <= 1
        assert (ours[:, -1] <= 0).all()

    def test_golden_bundle(self):
        data = np.load(os.path.join(GOLDEN, "decode_bundle.npz"))
        with open(os.path.join(GOLDEN, "decode_bundle.json")) as f:
            meta = json.load(f)
        alphabet = Alphabet.from_json(json.dumps(meta["alphabet"]))
        lp = data["log_probs"]
        frames = data["frames"]
        mask = np.arange(lp.shape[1])[None, :] < frames[:, None]
        hyps = greedy_decode(torch.from_numpy(lp), torch.from_numpy(mask),
                             alphabet)
        assert hyps == meta["greedy"]
        c, w = cer_wer(hyps, meta["refs"])
        assert c == pytest.approx(meta["greedy_cer"], abs=1e-9)
        assert w == pytest.approx(meta["greedy_wer"], abs=1e-9)

    def test_decode_skips_invalid_and_collapses(self):
        alphabet = Alphabet.from_charset("abc")
        row = np.array([0, 1, 0, 2, 0, 0, 3], np.int32)
        assert collapse_frames(row, alphabet) == "u0061 u0062 u0063"
        lp = np.full((2, 4, 4), -5.0, np.float32)
        lp[:, :, 1] = -0.1
        mask = np.ones((2, 4), bool)
        hyps = greedy_decode(torch.from_numpy(lp), torch.from_numpy(mask),
                             alphabet, valid=np.array([True, False]))
        assert hyps == ["u0061"]


def _line(rng, h, w):
    """Text-like synthetic content: paper + dark strokes."""
    img = np.full((h, w), 255, np.uint8)
    for _ in range(max(3, w // 12)):
        y = rng.integers(0, h)
        x = rng.integers(0, w)
        lw = rng.integers(1, max(2, w // 6))
        img[max(0, y - 1): y + 2, x: x + lw] = rng.integers(0, 90)
    return img


class TestResize:
    @pytest.mark.parametrize(
        "h,w", [(32, 200), (48, 311), (64, 123), (20, 64), (33, 257),
                (17, 80)])
    def test_matches_jax_within_one_level(self, h, w):
        out_h = 32
        rng = np.random.default_rng(h * 1000 + w)
        img = _line(rng, h, w)
        new_w = max(1, round(w * out_h / h))
        Hr, Wr = resize.MAX_SCALE * out_h, 2 * resize.MAX_SCALE * out_h * 8
        raw = np.full((2, Hr, Wr), 255, np.uint8)
        raw[0, :h, :w] = img
        hh = min(h, out_h)
        raw[1, :hh, :40] = img[:hh, :40]
        hs = np.array([h, hh], np.int32)
        ws = np.array([w, 40], np.int32)
        nws = np.array([new_w, max(1, round(40 * out_h / hh))], np.int32)
        ref = np.asarray(jax_resize.resized_to_uint8(jax_resize.resize_lines(
            jnp.asarray(raw), jnp.asarray(hs), jnp.asarray(ws),
            jnp.asarray(nws), out_h=out_h, out_w=Wr // 2)))
        ours = resize.resized_to_uint8(resize.resize_lines(
            torch.from_numpy(raw), torch.from_numpy(hs), torch.from_numpy(ws),
            torch.from_numpy(nws), out_h=out_h, out_w=Wr // 2)).numpy()
        assert ours.dtype == np.uint8 and ours.shape == ref.shape
        diff = np.abs(ours.astype(int) - ref.astype(int))
        assert diff.max() <= 1, diff.max()
        assert (ours[0, :, new_w:] == 255).all()

    def test_identity_when_already_normalized(self):
        rng = np.random.default_rng(0)
        img = _line(rng, 32, 120)
        raw = np.full((1, 64, 256), 255, np.uint8)
        raw[0, :32, :120] = img
        out = resize.resized_to_uint8(resize.resize_lines(
            torch.from_numpy(raw), torch.tensor([32], dtype=torch.int32),
            torch.tensor([120], dtype=torch.int32),
            torch.tensor([120], dtype=torch.int32), out_h=32, out_w=128))
        np.testing.assert_array_equal(out.numpy()[0, :, :120], img)

    @pytest.mark.parametrize("h,w", [(100, 50), (129, 77), (64, 10)])
    def test_host_pool_matches_jax(self, h, w):
        rng = np.random.default_rng(h + w)
        img = rng.integers(0, 256, (h, w), np.uint8)
        np.testing.assert_array_equal(resize.host_pool(img, 64),
                                      jax_resize.host_pool(img, 64))

    def test_round_half_away_from_zero(self):
        x = torch.tensor([0.5, 1.5, 2.49, 254.5, 300.0, -3.0])
        assert resize.resized_to_uint8(x).tolist() == [1, 2, 2, 255, 255, 0]
