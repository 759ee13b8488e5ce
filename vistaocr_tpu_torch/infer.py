"""Batch inference / evaluation entry — component C17 (SURVEY.md §2).

Counterpart of ``vistaocr_tpu/infer.py``: loads a self-describing
snapshot (``checkpoint.load_model``), runs a split through the bucketed
pipeline on one device, writes hypotheses and a CER/WER report, with the
same arguments and report keys: greedy decoding; the beam search on the
device (``--decoder beam``, ``--beam-impl device`` the default:
``decode/device_beam.py``, one CUDA graph per batch shape on the card,
with the char LM, lexicon and word LM fused in the search, two-pass LM
rescoring of the W finals where the LM is not fused, and ``--nbest``);
and on the host (``--beam-impl host``: the C++ engine or the Python
expansion); int8 (``--quantize int8``: the snapshot's stored qstack, or
one calibrated on the train split, ``models/quant.py``).
``--dump-posteriors`` writes the JAX package's dump format, so either
package's ``decode.offline`` reads it.

Usage:
    python -m vistaocr_tpu_torch.infer --snapshot <dir>/best \\
        --data <dataset> --split test [--out hyps.jsonl] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time
from collections import deque
from typing import Optional

import numpy as np

from .checkpoint import load_model
from .data.pipeline import BatchPipeline
from .runtime import HostCopy, disable_tf32
from .text import cer_wer, uxxxx_to_utf8
from .text.bidi import display_order as _bidi_display
from .text.bidi import is_rtl_line as _bidi_is_rtl
from .train import make_eval_step

# Batches dispatched ahead of the host finalize. Each in-flight entry pins
# its device results (and, in beam mode, the batch's [B, T, K] log-probs)
# until finalized, so the window bounds device memory.
_INFLIGHT_WINDOW = 16


def _collect_refs(indices, valid, ds, refs, ids):
    for i, v in zip(indices, valid):
        if v:
            refs.append(ds.transcript(int(i)))
            ids.append(ds[int(i)].id)


class _PosteriorDumper:
    """Per-frame posterior export, the JAX package's format
    (``vistaocr_tpu.posteriors.v1``): <dir>/meta.json (alphabet and
    provenance) and one posteriors_<n>.npz per batch: ids (valid rows
    only), frames, and f16 log_probs trimmed to the batch's longest valid
    frame count. Consume with ``iter_posteriors``."""

    def __init__(self, out_dir, alphabet, snapshot, split, ds):
        import os

        self.dir = out_dir
        self.ds = ds
        self.n = 0
        self.q = []
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, "meta.json"), "w") as f:
            json.dump({
                "format": "vistaocr_tpu.posteriors.v1",
                "alphabet": json.loads(alphabet.to_json()),
                "snapshot": snapshot,
                "split": split,
            }, f, ensure_ascii=False)

    def add(self, batch, log_probs, frame_mask):
        self.q.append((batch.indices, batch.valid,
                       HostCopy([log_probs, frame_mask])))

    def flush_one(self):
        import os

        indices, valid, copy = self.q.pop(0)
        lp, frame_mask = copy.get()
        frames = frame_mask.sum(axis=1).astype(np.int32)
        keep = np.flatnonzero(np.asarray(valid))
        if keep.size == 0:
            return
        frames = frames[keep]
        fmax = int(frames.max())
        np.savez_compressed(
            os.path.join(self.dir, f"posteriors_{self.n:05d}.npz"),
            ids=np.array([self.ds.id(int(indices[i])) for i in keep]),
            frames=frames,
            log_probs=lp[keep, :fmax].astype(np.float16),
        )
        self.n += 1

    def close(self):
        while self.q:
            self.flush_one()


def iter_posteriors(dump_dir):
    """Yield ``(line_id, log_probs[T, V] float32)`` from a
    ``--dump-posteriors`` directory, trimmed to each line's true frame
    count. Pairs with ``load_posterior_alphabet``."""
    import glob
    import os

    for path in sorted(glob.glob(os.path.join(dump_dir, "posteriors_*.npz"))):
        with np.load(path) as z:
            ids, frames, lp = z["ids"], z["frames"], z["log_probs"]
            for i in range(len(ids)):
                yield str(ids[i]), lp[i, : int(frames[i])].astype(np.float32)


def iter_posterior_batches(dump_dir):
    """Yield ``(ids [n], frames [n] int32, log_probs [n, fmax, V] f32)``
    per dump file, the dump's own batch granularity (lines of one
    bucketed batch, so of similar frame counts)."""
    import glob
    import os

    for path in sorted(glob.glob(os.path.join(dump_dir, "posteriors_*.npz"))):
        with np.load(path) as z:
            yield (
                [str(i) for i in z["ids"]],
                z["frames"].astype(np.int32),
                z["log_probs"].astype(np.float32),
            )


def load_posterior_alphabet(dump_dir):
    import os

    from .text import Alphabet

    with open(os.path.join(dump_dir, "meta.json")) as f:
        meta = json.load(f)
    return Alphabet.from_json(json.dumps(meta["alphabet"]))


def run_inference(
    snapshot: str,
    data_dir: str,
    split: str = "test",
    *,
    batch_pixels: int = 2**21,
    out_path: Optional[str] = None,
    eval_align: int = 128,  # re-bucket the snapshot ladder (0 = keep)
    decoder: str = "greedy",  # greedy | beam
    beam_impl: str = "device",  # device | host
    beam_config=None,
    lm_path: Optional[str] = None,
    lm_alpha: float = 0.5,
    lm_beta: float = 0.0,
    dump_posteriors: Optional[str] = None,
    nbest: int = 1,
    lexicon_path: Optional[str] = None,
    lex_unk_logp: float = 0.0,  # <unk> bypass per-char penalty (0 = hard)
    word_lm_path: Optional[str] = None,
    word_lm_alpha: float = 0.5,
    word_lm_beta: float = 0.0,
    quantize: str = "none",  # "none" | "int8" (PTQ conv stack, models/quant.py)
    quantize_float_prefix: int = 0,
    calib_batches: int = 4,
    log=print,
    device="cuda",
) -> dict:
    """The JAX ``run_inference`` on one device (``device``: ``"cuda"``
    raises without a card; the CPU runs only when asked for)."""
    from .decode import BeamConfig, beam_decode, load_lm

    if decoder not in ("greedy", "beam"):
        raise ValueError(f"unknown decoder {decoder!r}")
    if beam_impl not in ("device", "host"):
        raise ValueError(f"unknown beam_impl {beam_impl!r}")
    if quantize not in ("none", "int8"):
        raise ValueError(f"unknown --quantize mode {quantize!r}")

    disable_tf32()
    model, alphabet, contract = load_model(snapshot, device)
    dev = next(model.parameters()).device
    if eval_align:
        # one-shot eval wants a coarse ladder: fewer distinct shapes, the
        # same CER (width masks carry the true widths); as
        # serve.ServiceConfig.serve_align
        import dataclasses as _dc

        coarse = tuple(sorted({
            -(-w // eval_align) * eval_align for w in contract.bucket_widths
        }))
        contract = _dc.replace(contract, bucket_widths=coarse)
    # comma-joined corpus specs evaluate like they train (open_dataset)
    from .data.shards import open_dataset

    ds = open_dataset(data_dir, split)
    pipe = BatchPipeline(
        ds, alphabet, contract, batch_pixels=batch_pixels,
        drop_remainder=False, shuffle=False,
    )
    if pipe.dropped:
        log(f"warning: {pipe.dropped} lines fit no bucket; skipped")
    eval_step = make_eval_step(model)
    if quantize == "int8":
        # int8 PTQ of the conv stack (models/quant.py); bridge, BLSTM and
        # head keep the model's type, logits stay f32
        from .models.quant import (
            calibration_batches,
            load_qstack,
            make_quantized_eval_step,
            quantize_model,
        )

        # prefer the snapshot's stored artifact: no calibration pass,
        # the same result every run
        qstack = load_qstack(snapshot)
        if qstack is not None:
            log("int8 PTQ: loaded stored qstack from snapshot")
        else:
            # calibrate on the TRAIN split where the dataset has one, so
            # the scored split does not set the scales
            calib = calibration_batches(
                data_dir, snapshot, calib_batches=calib_batches,
                batch_pixels=batch_pixels, split="train")
            qstack = quantize_model(model, calib)
            log(f"int8 PTQ: conv stack quantized "
                f"(calibrated over {len(calib)} train batches)")
        eval_step = make_quantized_eval_step(
            model, qstack, float_prefix=quantize_float_prefix)

    lexicon = None
    if lexicon_path:
        if decoder != "beam":
            raise ValueError("--lexicon needs --decoder beam")
        from .decode.lexicon import Lexicon

        lexicon = Lexicon.read_words(alphabet, lexicon_path)
    if nbest > 1 and decoder != "beam":
        raise ValueError("--nbest needs --decoder beam")
    word_lm = None
    if word_lm_path:
        if decoder != "beam":
            raise ValueError("--word-lm needs --decoder beam")
        from .decode.lm import ArpaLM

        word_lm = ArpaLM.read_arpa(word_lm_path)
        if beam_impl == "device" and (lexicon is None or word_lm.order > 3):
            raise ValueError(
                "device word fusion needs --lexicon and a word LM of "
                "order <= 3 (bigram dense/hashed, trigram hashed); use "
                "--beam-impl host otherwise")
    # One LM load, picked for the engine that will run: the host's Python
    # expansion (n-best, or a word LM above bigram) needs the Python
    # ArpaLM; every other path takes load_lm's choice (NativeLM when the
    # C++ engine is built).
    py_expansion = beam_impl == "host" and (
        nbest > 1 or (word_lm is not None and word_lm.order > 2))
    if not lm_path:
        lm = None
    elif py_expansion:
        from .decode.lm import ArpaLM

        lm = ArpaLM.read_arpa(lm_path)
    else:
        lm = load_lm(lm_path, alphabet)
    if decoder == "beam" and beam_config is None:
        beam_config = BeamConfig(
            lm_alpha=lm_alpha if lm else 0.0, lm_beta=lm_beta,
            word_lm_alpha=word_lm_alpha if word_lm is not None else 0.0,
            word_lm_beta=word_lm_beta,
            lex_unk_logp=lex_unk_logp if lexicon is not None else 0.0,
        )
    dumper = (
        _PosteriorDumper(dump_posteriors, alphabet, snapshot, split, ds)
        if dump_posteriors else None
    )

    hyps, refs, ids = [], [], []
    confs: list = []  # per-line confidence; parallel to hyps where defined
    lm_fusion = None  # how the LMs run in the device beam, for the report
    nbest_lists: list = []  # per-line ranked (uxxxx, score), --nbest > 1
    t0 = time.time()
    # Two phases, as in serve.OcrService.ocr_lines: dispatch each batch's
    # device work and start its device->host copy, then finalize on the
    # host in order, up to _INFLIGHT_WINDOW batches behind.
    ds_widths = ds.widths

    def _conf_of(line_index: int, logp: float) -> float:
        # normalise the decode's log-prob by the line's frame count (known
        # on the host from its true width): a per-frame geometric mean
        frames = contract.frames_for_width(int(ds_widths[line_index]))
        return float(np.exp(min(logp / max(frames, 1), 0.0)))

    def _add_nbest(lists):
        for ranked in lists:
            hyps.append(ranked[0][0] if ranked else "")
            confs.append(None)
            nbest_lists.append(ranked)

    if decoder == "beam" and beam_impl == "device":
        from .decode.device_beam import (
            beam_scan_program,
            device_beam_decode,
            device_beam_nbest,
            device_tables,
        )
        from .decode.greedy import SCORE_SCALE, collapse_frames

        # The char LM fused in the search at order 2-3 (dense table) or 4
        # (hashed contexts); higher orders are rescored on the host
        # (two-pass). The lexicon and word LM run in the search too.
        tables: dict = {}
        with_lm = lm is not None and beam_config.lm_alpha != 0
        if with_lm:
            from .decode.lm import ArpaLM, dense_logp_table, hashed_logp_table

            py_lm = lm if isinstance(lm, ArpaLM) else ArpaLM.read_arpa(
                lm_path)
            if 2 <= py_lm.order <= 3:
                tables["lm_table"] = dense_logp_table(py_lm, alphabet)
                lm_fusion = "device-interleaved"
            elif py_lm.order == 4:
                t = hashed_logp_table(py_lm, alphabet)
                tables.update(lm_table=t["t3"], lm_hash_keys=t["keys"],
                              lm_hash_vals=t["vals"], lm_rows=t["rows"],
                              lm_probes=int(t["probes"]))
                lm_fusion = "device-interleaved-4gram"
        if lexicon is not None:
            if with_lm and "lm_table" not in tables:
                raise ValueError(
                    "device lexicon decoding with an LM needs order <= 4 "
                    "(fused); use --beam-impl host for higher orders")
            use_unk = beam_config.lex_unk_logp != 0.0
            next_tbl, boundary = lexicon.dense_tables(unk=use_unk)
            tables.update(lex_next=next_tbl, lex_boundary=boundary)
            if use_unk:
                tables.update(lex_unk_logp=float(beam_config.lex_unk_logp),
                              space_id=lexicon.space_id)
            if word_lm is not None and beam_config.word_lm_alpha != 0:
                from .decode.lm import device_word_tables, word_unk_logp

                tables.update(
                    device_word_tables(word_lm, lexicon.words),
                    word_ids=lexicon.word_id_table(unk=use_unk),
                    space_id=lexicon.space_id,
                    word_alpha=float(beam_config.word_lm_alpha),
                    word_beta=float(beam_config.word_lm_beta))
                if use_unk:
                    tables["word_unk_logp"] = float(word_unk_logp(word_lm))
                lm_fusion = (lm_fusion or "") + "+device-word"
        kw = device_tables(tables, dev)
        fused = bool(tables)
        prog = beam_scan_program(
            beam_config, all_beams=nbest > 1 or (with_lm and not fused),
            fused_lm=fused)

        def dispatch(batch, log_probs, frame_mask):
            out = prog(log_probs, frame_mask, **kw)
            # with a fused LM or lexicon only the packed rows leave
            return HostCopy(out[1:] if fused and nbest == 1 else out)

        def finalize(entry):
            indices, valid, _, copy = entry
            pre = copy.get()
            if nbest > 1:  # fused finals are final; else rescored here
                _add_nbest(device_beam_nbest(
                    alphabet, beam_config, pre, lm=None if fused else lm,
                    valid=valid, nbest=nbest))
            elif fused:
                (packed,) = pre  # [B, T+1]
                for i in np.flatnonzero(np.asarray(valid)):
                    hyps.append(collapse_frames(packed[i, :-1], alphabet))
                    confs.append(_conf_of(int(indices[i]),
                                          packed[i, -1] / SCORE_SCALE))
            else:
                scored = device_beam_decode(
                    None, None, alphabet, beam_config, lm=lm, valid=valid,
                    precomputed=pre, return_scores=True)
                for (hyp, ctc), i in zip(scored,
                                         np.flatnonzero(np.asarray(valid))):
                    hyps.append(hyp)
                    confs.append(_conf_of(int(indices[i]), ctc))
            _collect_refs(indices, valid, ds, refs, ids)
    elif decoder == "beam":
        from .decode.beam import beam_topk

        def dispatch(batch, log_probs, frame_mask):
            topk = beam_topk(log_probs, min(beam_config.topk,
                                            log_probs.shape[-1]))
            return HostCopy([log_probs, frame_mask, *topk])

        def finalize(entry):
            indices, valid, _, copy = entry
            log_probs, frame_mask, vals, tids = copy.get()
            decoded = beam_decode(
                log_probs, frame_mask, alphabet, beam_config, lm=lm,
                valid=valid, precomputed_topk=(vals, tids), lexicon=lexicon,
                word_lm=word_lm, nbest=nbest,
            )
            if nbest > 1:  # ranked (uxxxx, score) lists per line
                _add_nbest(decoded)
            else:
                hyps.extend(decoded)
                confs.extend([None] * len(decoded))  # host: no scores
            _collect_refs(indices, valid, ds, refs, ids)
    else:
        from .decode.greedy import (
            SCORE_SCALE,
            collapse_frames,
            greedy_frames_packed,
        )

        def dispatch(batch, log_probs, frame_mask):
            return HostCopy([greedy_frames_packed(log_probs, frame_mask)])

        def finalize(entry):
            indices, valid, size, copy = entry
            (packed,) = copy.get()  # [B, T+1]: id rows + score column
            for i in range(size):
                if not valid[i]:
                    continue
                hyps.append(collapse_frames(packed[i, :-1], alphabet))
                confs.append(_conf_of(
                    int(indices[i]), packed[i, -1] / SCORE_SCALE
                ))
            _collect_refs(indices, valid, ds, refs, ids)

    inflight = deque()
    for batch in pipe.device_epoch(0, device=dev):
        log_probs, frame_mask = eval_step(batch.images, batch.widths)
        copy = dispatch(batch, log_probs, frame_mask)
        if dumper:
            dumper.add(batch, log_probs, frame_mask)
            if len(dumper.q) >= _INFLIGHT_WINDOW:
                dumper.flush_one()
        # keep only what finalize needs: the batch's device images go as
        # soon as its work retires
        inflight.append((batch.indices, batch.valid, batch.size, copy))
        if len(inflight) >= _INFLIGHT_WINDOW:
            finalize(inflight.popleft())
    while inflight:
        finalize(inflight.popleft())
    if dumper:
        dumper.close()
    dt = max(time.time() - t0, 1e-9)
    c, w = cer_wer(hyps, refs)
    report = {
        "snapshot": snapshot,
        "split": split,
        "decoder": (
            f"{decoder}:{beam_impl}" if decoder == "beam" else decoder
        ),
        **({"lm_fusion": lm_fusion} if lm_fusion else {}),
        **({"quantize": quantize} if quantize != "none" else {}),
        "lines": len(hyps),
        "cer": round(c, 5),
        "wer": round(w, 5),
        "lines_per_sec": round(len(hyps) / dt, 1),
    }
    scored = [c for c in confs if c is not None]
    if scored:
        report["mean_confidence"] = round(float(np.mean(scored)), 5)
    if out_path:
        if len(confs) != len(hyps):  # defensive: never misalign the report
            confs = [None] * len(hyps)
        with open(out_path, "w") as f:
            for n, (lid, hyp, ref, conf) in enumerate(
                zip(ids, hyps, refs, confs)
            ):
                hyp_text = uxxxx_to_utf8(hyp)
                rec = {
                    "id": lid,
                    "hyp_uxxxx": hyp,
                    "hyp_text": hyp_text,
                    "ref_uxxxx": ref,
                    "conf": round(conf, 5) if conf is not None else None,
                }
                if _bidi_is_rtl(hyp_text):
                    # RTL models emit scan-order text; ship the
                    # reading-order form alongside
                    rec["hyp_text_logical"] = _bidi_display(hyp_text)
                if nbest_lists:
                    rec["nbest"] = [
                        {"hyp_uxxxx": h, "hyp_text": uxxxx_to_utf8(h),
                         "score": round(s_, 4)}
                        for h, s_ in nbest_lists[n]
                    ]
                f.write(json.dumps(rec, ensure_ascii=False) + "\n")
    log(json.dumps(report))
    return report


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--snapshot", required=True)
    p.add_argument("--data", required=True)
    p.add_argument("--split", default="test")
    p.add_argument("--out", default=None)
    p.add_argument("--batch-pixels", type=int, default=2**21)
    p.add_argument("--eval-align", type=int, default=128,
                   help="re-bucket the snapshot ladder onto this alignment "
                        "for eval (fewer distinct shapes); 0 keeps it")
    p.add_argument("--decoder", choices=("greedy", "beam"), default="greedy")
    p.add_argument("--beam-impl", choices=("device", "host"), default="device",
                   help="beam engine: the search on the device (device; "
                        "one CUDA graph per batch shape on a card) or the "
                        "host C++/Python expansion (host)")
    p.add_argument("--word-lm", default=None, metavar="ARPA",
                   help="word-level ARPA LM (utf8 word tokens): fuse at "
                        "word boundaries (the device beam needs --lexicon "
                        "and order <= 3)")
    p.add_argument("--word-lm-alpha", type=float, default=0.5)
    p.add_argument("--word-lm-beta", type=float, default=0.0)
    p.add_argument("--lexicon", default=None, metavar="WORDS",
                   help="word list (one per line, utf8): constrain beam "
                        "hypotheses to lexicon words")
    p.add_argument("--lex-unk-logp", type=float, default=0.0,
                   help="with --lexicon: per-character log penalty for "
                        "out-of-lexicon words (<unk> character-bypass "
                        "escape, e.g. -4); 0 keeps the HARD constraint")
    p.add_argument("--nbest", type=int, default=1,
                   help="with --decoder beam: write the top-N ranked "
                        "hypotheses per line into --out")
    p.add_argument("--dump-posteriors", default=None, metavar="DIR",
                   help="also export per-frame log-probs (f16 npz per "
                        "batch + alphabet meta) for external decoding/"
                        "rescoring (decode.offline)")
    p.add_argument("--lm", default=None, help="ARPA LM path for beam fusion")
    p.add_argument("--lm-alpha", type=float, default=0.5)
    p.add_argument("--lm-beta", type=float, default=0.0)
    p.add_argument("--quantize", choices=("none", "int8"), default="none",
                   help="int8: post-training-quantize the conv stack "
                        "(BN-folded per-channel int8 weights, calibrated "
                        "activation scales; the snapshot's stored "
                        "qstack.msgpack when it has one)")
    p.add_argument("--quantize-float-prefix", type=int, default=0,
                   help="with --quantize int8: keep the first N convs "
                        "in float (folded kernels)")
    p.add_argument("--calib-batches", type=int, default=4,
                   help="with --quantize: calibration batches drawn from "
                        "the train split when the snapshot stores no "
                        "qstack")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; raises without a card)")
    args = p.parse_args(argv)
    run_inference(
        args.snapshot, args.data, args.split,
        batch_pixels=args.batch_pixels, out_path=args.out,
        eval_align=args.eval_align,
        decoder=args.decoder, beam_impl=args.beam_impl, lm_path=args.lm,
        lm_alpha=args.lm_alpha, lm_beta=args.lm_beta,
        dump_posteriors=args.dump_posteriors,
        nbest=args.nbest,
        lexicon_path=args.lexicon,
        lex_unk_logp=args.lex_unk_logp,
        word_lm_path=args.word_lm,
        word_lm_alpha=args.word_lm_alpha,
        word_lm_beta=args.word_lm_beta,
        quantize=args.quantize,
        quantize_float_prefix=args.quantize_float_prefix,
        calib_batches=args.calib_batches,
        device=args.device,
    )


if __name__ == "__main__":
    main()
