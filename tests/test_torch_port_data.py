"""The port's training data layer against the JAX package: the shard
store (a directory written by either package reads in both), the bucket
ladder of ``make_ladder``, ``BatchPipeline.plan`` and the batches it
assembles (bit-identical), ``device_epoch`` on the CPU, and the CER/WER
copy."""

import numpy as np
import pytest
import torch

from vistaocr_tpu.data import buckets as jax_buckets
from vistaocr_tpu.data import pipeline as jax_pipeline
from vistaocr_tpu.data import shards as jax_shards
from vistaocr_tpu.text import Alphabet as JaxAlphabet
from vistaocr_tpu.text import error_rates as jax_er

from vistaocr_tpu_torch.data import (BatchPipeline, ShapeContract,
                                     ShardedLineDataset, ShardWriter,
                                     make_ladder, open_dataset,
                                     write_manifest)
from vistaocr_tpu_torch.text import Alphabet, cer_wer, levenshtein, utf8_to_uxxxx


def _write(mod, d, seed, n_train=70, n_val=9):
    """A small shard directory with ``mod``'s writer: random strokes,
    widths 20..400, text from a small charset."""
    rng = np.random.default_rng(seed)
    splits = {}
    for split, n in (("train", n_train), ("val", n_val)):
        w = mod.ShardWriter(str(d), split, 32, max_shard_bytes=60_000)
        for i in range(n):
            width = int(rng.integers(20, 400))
            img = rng.integers(0, 256, (32, width), dtype=np.uint8)
            text = "".join(rng.choice(list("abc de"), int(rng.integers(1, 12))))
            w.add(f"{split}-{i}", img, utf8_to_uxxxx(text))
        splits[split] = w.close()
    mod.write_manifest(str(d), 32, splits)
    return str(d)


class _PortShards:
    ShardWriter = ShardWriter
    write_manifest = staticmethod(write_manifest)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_shards_read_equal_in_both(tmp_path, writer):
    d = _write(_PortShards if writer == "port" else jax_shards, tmp_path, 0)
    ours = ShardedLineDataset(d, "train")
    theirs = jax_shards.ShardedLineDataset(d, "train")
    assert len(ours) == len(theirs) == 70
    assert len(ours._mmaps) > 1  # several shards
    np.testing.assert_array_equal(ours.widths, theirs.widths)
    assert list(ours.transcripts()) == list(theirs.transcripts())
    for i in (0, 33, 69):
        np.testing.assert_array_equal(ours[i].image, theirs[i].image)
        a = np.full((32, 512), 255, np.uint8)
        b = a.copy()
        assert ours.read_into(i, a) == theirs.read_into(i, b)
        np.testing.assert_array_equal(a, b)
    both = open_dataset(f"{d},{d}", "val")
    val = ShardedLineDataset(d, "val")
    assert len(both) == 18 and both.transcript(9) == val.transcript(0)
    with pytest.raises(KeyError):
        open_dataset(d, "test")


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_make_ladder_equals_jax(seed):
    rng = np.random.default_rng(seed)
    widths = np.concatenate([rng.integers(40, 2048, 300),
                             rng.normal(600, 80, 200).astype(int).clip(8)])
    for kw in (dict(align=32, max_waste=0.03, max_width=2048),
               dict(align=128, max_waste=0.10)):
        assert make_ladder(widths, **kw) == jax_buckets.make_ladder(widths,
                                                                   **kw)


def test_pipeline_plan_and_batches_identical(tmp_path):
    d = _write(_PortShards, tmp_path, 1, n_train=120)
    ds = ShardedLineDataset(d, "train")
    jds = jax_shards.ShardedLineDataset(d, "train")
    alpha = Alphabet.build(ds.transcripts())
    jalpha = JaxAlphabet.build(jds.transcripts())
    assert alpha.to_json() == jalpha.to_json()
    kw = dict(batch_pixels=2**16, seed=3)
    c = ShapeContract(bucket_widths=(128, 256, 384))
    jc = jax_buckets.ShapeContract(bucket_widths=(128, 256, 384))
    for drop, shuffle in ((True, True), (False, False)):
        ours = BatchPipeline(ds, alpha, c, drop_remainder=drop,
                             shuffle=shuffle, **kw)
        theirs = jax_pipeline.BatchPipeline(jds, jalpha, jc,
                                            drop_remainder=drop,
                                            shuffle=shuffle, **kw)
        assert ours.batch_sizes == theirs.batch_sizes
        assert ours.label_caps == theirs.label_caps
        assert ours.dropped == theirs.dropped and len(ours) == len(theirs)
        for epoch in (0, 1):
            assert ours.plan(epoch) == theirs.plan(epoch)
        for a, b in zip(ours.epoch(1), theirs.epoch(1)):
            for f in ("images", "widths", "labels", "label_lengths", "valid",
                      "indices"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
            assert a.bucket.__dict__ == b.bucket.__dict__


def test_device_epoch_on_cpu_and_early_stop(tmp_path):
    d = _write(_PortShards, tmp_path, 2, n_train=120)
    ds = ShardedLineDataset(d, "train")
    pipe = BatchPipeline(ds, Alphabet.build(ds.transcripts()),
                         ShapeContract(bucket_widths=(128, 256, 384)),
                         batch_pixels=2**16, seed=0)
    host = list(pipe.epoch(0))
    dev = list(pipe.device_epoch(0, device="cpu"))
    assert len(host) == len(dev) > 1
    for a, b in zip(host, dev):
        assert isinstance(b.images, torch.Tensor)
        assert b.images.dtype == torch.uint8
        np.testing.assert_array_equal(a.images, b.images.numpy())
        np.testing.assert_array_equal(a.labels, b.labels.numpy())
    it = pipe.device_epoch(0, device="cpu", prefetch=1)
    next(it)
    it.close()  # the producer thread is released


@pytest.mark.parametrize("pair", [("a b c", "a b c"), ("abc d", "abd"),
                                  ("", "xy z"), ("hello  world", "helo wrld"),
                                  ("سلام دنیا", "سلم دنیا")])
def test_error_rates_copy_agrees(pair):
    hyp, ref = (utf8_to_uxxxx(t) for t in pair)
    assert cer_wer([hyp], [ref]) == jax_er.cer_wer([hyp], [ref])
    assert levenshtein(hyp.split(), ref.split()) == jax_er.levenshtein(
        hyp.split(), ref.split())
