from .greedy import (
    SCORE_SCALE,
    collapse_frames,
    greedy_decode,
    greedy_frames,
    greedy_frames_packed,
)

__all__ = ["SCORE_SCALE", "collapse_frames", "greedy_decode",
           "greedy_frames", "greedy_frames_packed"]
