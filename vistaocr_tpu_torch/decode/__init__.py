from .greedy import (
    SCORE_SCALE,
    collapse_frames,
    greedy_decode,
    greedy_frames,
    greedy_frames_packed,
)
from .beam import BeamConfig, beam_decode, beam_topk, load_lm, prefix_beam_search
from .lexicon import Lexicon
from .lm import ArpaLM, train_char_lm
from .offline import decode_posteriors, greedy_decode_np

__all__ = ["SCORE_SCALE", "collapse_frames", "greedy_decode",
           "greedy_frames", "greedy_frames_packed", "BeamConfig",
           "beam_decode", "beam_topk", "load_lm", "prefix_beam_search",
           "Lexicon", "ArpaLM", "train_char_lm", "decode_posteriors",
           "greedy_decode_np"]
