"""Offline decoding over a ``--dump-posteriors`` export — the consumer
half of the reference's external-decode surface (SURVEY.md §3.3: dump
per-frame posteriors, then decode/rescore them in a SEPARATE process
with LM tooling). Counterpart of ``vistaocr_tpu/decode/offline.py``; the
dump format (``vistaocr_tpu.posteriors.v1``) is the same in both
packages, so either one decodes the other's dumps. Everything here runs
on the host: greedy is pure numpy, beam rides the host prefix-beam
engine (the C++ engine when built, the Python expansion otherwise) — the
GPU is never touched, so LM sweeps and error analysis iterate at host
speed on posteriors the card computed once.

Typical flow::

    python -m vistaocr_tpu_torch.infer --snapshot run/best --data d \
        --split test --dump-posteriors post/
    python -m vistaocr_tpu_torch.decode.offline --posteriors post/ \
        --decoder beam --lm lm.arpa --lm-alpha 0.4 --lm-beta 0.4 \
        --data d --out hyps.jsonl
"""

from __future__ import annotations

import json
import time
from typing import Dict, Optional

import numpy as np

from ..text import Alphabet, cer_wer
from .beam import BeamConfig, beam_decode, load_lm


def greedy_decode_np(log_probs: np.ndarray, alphabet: Alphabet) -> str:
    """Pure-numpy greedy CTC decode of one line's [T, V] log-probs:
    argmax per frame, collapse repeats, drop blanks (index 0). Matches
    decode.greedy.greedy_decode on the same frames — kept jax-free so
    offline consumers need no accelerator stack at all."""
    path = log_probs.argmax(axis=1)
    keep = np.flatnonzero((path != 0) & np.diff(path, prepend=-1).astype(bool))
    return alphabet.decode(path[keep].tolist())


def decode_posteriors(
    dump_dir: str,
    *,
    decoder: str = "greedy",
    lm_path: Optional[str] = None,
    lm_alpha: float = 0.5,
    lm_beta: float = 0.0,
    beam_width: int = 16,
    topk: int = 8,
    lexicon_path: Optional[str] = None,
    lex_unk_logp: float = 0.0,
    word_lm_path: Optional[str] = None,
    word_lm_alpha: float = 0.5,
    word_lm_beta: float = 0.0,
    refs: Optional[Dict[str, str]] = None,
    out_path: Optional[str] = None,
    log=print,
) -> dict:
    """Decode every line in a posterior dump. Returns a report dict
    (lines, lines_per_sec, and CER/WER when ``refs`` maps line id ->
    uxxxx transcript); writes per-line hypotheses to ``out_path`` as
    JSONL when given."""
    from ..infer import iter_posteriors, load_posterior_alphabet

    if lexicon_path and decoder != "beam":
        raise ValueError("lexicon_path needs decoder='beam'")
    alphabet = load_posterior_alphabet(dump_dir)
    t0 = time.time()
    hyps: Dict[str, str] = {}
    confs: Dict[str, float] = {}  # greedy only (host beam has no scores)

    if decoder == "greedy":
        for lid, lp in iter_posteriors(dump_dir):
            hyps[lid] = greedy_decode_np(lp, alphabet)
            if lp.shape[0]:
                # per-frame geometric-mean best-path probability — same
                # definition as infer/serve confidence
                confs[lid] = float(np.exp(min(lp.max(axis=1).mean(), 0.0)))
    elif decoder == "beam":
        from ..infer import iter_posterior_batches

        lexicon = None
        if lexicon_path:
            from .lexicon import Lexicon

            lexicon = Lexicon.read_words(alphabet, lexicon_path)
        word_lm = None
        if word_lm_path:
            from .lm import ArpaLM

            word_lm = ArpaLM.read_arpa(word_lm_path)
        lm = load_lm(lm_path, alphabet) if lm_path else None
        config = BeamConfig(
            beam_width=beam_width, topk=topk,
            lm_alpha=lm_alpha if lm is not None else 0.0, lm_beta=lm_beta,
            word_lm_alpha=(word_lm_alpha if word_lm is not None else 0.0),
            word_lm_beta=word_lm_beta,
            lex_unk_logp=lex_unk_logp if lexicon is not None else 0.0,
        )
        k = min(config.topk, alphabet.num_classes - 1)
        # stream one dump file at a time — each file is one bucketed batch
        # (similar frame counts), so padding stays small and corpus-scale
        # dumps never materialize in host RAM
        for lids, frames, lp in iter_posterior_batches(dump_dir):
            mask = np.arange(lp.shape[1])[None, :] < frames[:, None]
            # numpy top-k over symbols (blank handled separately by the
            # expansion) — same candidate rule as prefix_beam_search
            ids = (np.argsort(-lp[:, :, 1:], axis=2)[:, :, :k] + 1).astype(
                np.int32
            )
            vals = np.take_along_axis(lp, ids, axis=2)
            decoded = beam_decode(
                lp, mask, alphabet, config, lm=lm,
                precomputed_topk=(vals, ids), lexicon=lexicon,
                word_lm=word_lm,
            )
            for lid, hyp in zip(lids, decoded):
                hyps[lid] = hyp
    else:
        raise ValueError(f"unknown decoder {decoder!r}")

    dt = max(time.time() - t0, 1e-9)
    report = {
        "posteriors": dump_dir,
        "decoder": decoder,
        "lines": len(hyps),
        "lines_per_sec": round(len(hyps) / dt, 1),
    }
    if refs is not None:
        pairs = [(hyps[i], refs[i]) for i in hyps if i in refs]
        if len(pairs) != len(hyps):
            log(f"warning: {len(hyps) - len(pairs)} decoded ids have no ref")
        c, w = cer_wer([h for h, _ in pairs], [r for _, r in pairs])
        report.update(cer=round(c, 5), wer=round(w, 5), scored=len(pairs))
    if out_path:
        from ..text import uxxxx_to_utf8

        with open(out_path, "w") as f:
            for lid in sorted(hyps):
                rec = {
                    "id": lid,
                    "hyp_uxxxx": hyps[lid],
                    # same key as infer --out so downstream tooling sees
                    # one hypotheses-JSONL schema from both producers
                    "hyp_text": uxxxx_to_utf8(hyps[lid]),
                }
                if lid in confs:
                    rec["conf"] = round(confs[lid], 5)
                f.write(json.dumps(rec, ensure_ascii=False) + "\n")
    log(json.dumps(report))
    return report


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(
        description="Decode a --dump-posteriors export on the host "
        "(no GPU): greedy or beam+LM, with CER/WER when refs are given"
    )
    p.add_argument("--posteriors", required=True, help="dump directory")
    p.add_argument("--decoder", choices=("greedy", "beam"), default="greedy")
    p.add_argument("--lm", default=None, help="ARPA LM path for beam fusion")
    p.add_argument("--lm-alpha", type=float, default=0.5)
    p.add_argument("--lm-beta", type=float, default=0.0)
    p.add_argument("--beam-width", type=int, default=16)
    p.add_argument("--topk", type=int, default=8)
    p.add_argument("--lexicon", default=None, metavar="WORDS",
                   help="word list: constrain beam hypotheses to lexicon "
                        "words (host trie constraint)")
    p.add_argument("--lex-unk-logp", type=float, default=0.0,
                   help="with --lexicon: <unk> character-bypass penalty "
                        "per char (0 = hard constraint)")
    p.add_argument("--word-lm", default=None, metavar="ARPA",
                   help="word-level ARPA LM fused at word boundaries")
    p.add_argument("--word-lm-alpha", type=float, default=0.5)
    p.add_argument("--word-lm-beta", type=float, default=0.0)
    p.add_argument("--data", default=None,
                   help="dataset dir for references (CER/WER report)")
    p.add_argument("--split", default=None,
                   help="ref split (default: the dump's own split)")
    p.add_argument("--out", default=None, help="hypotheses JSONL path")
    args = p.parse_args(argv)

    refs = None
    if args.data:
        import os

        from ..data.shards import open_dataset

        with open(os.path.join(args.posteriors, "meta.json")) as f:
            split = args.split or json.load(f)["split"]
        ds = open_dataset(args.data, split)
        refs = {
            lid: ds.transcript(i) for i, lid in enumerate(ds.ids())
        }
    decode_posteriors(
        args.posteriors,
        decoder=args.decoder,
        lm_path=args.lm,
        lm_alpha=args.lm_alpha,
        lm_beta=args.lm_beta,
        beam_width=args.beam_width,
        topk=args.topk,
        lexicon_path=args.lexicon,
        lex_unk_logp=args.lex_unk_logp,
        word_lm_path=args.word_lm,
        word_lm_alpha=args.word_lm_alpha,
        word_lm_beta=args.word_lm_beta,
        refs=refs,
        out_path=args.out,
    )


if __name__ == "__main__":
    main()
