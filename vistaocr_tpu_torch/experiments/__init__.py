"""Counterparts of the JAX package's quarantined experiments
(``experiments/`` at the repository root), each with a hand-written CUDA
kernel pair, so that the card can measure them against the production
path:

- ``stem_cuda``: the fused input stem (preprocess + the first 3x3 conv,
  C_in = 1) and its kernel gradient, of ``experiments/stem_pallas.py``;
- ``lstm_bi_stacked``: the direction-stacked BLSTM layer (both
  directions as the planes of one ``[T, 2, B, *]`` layout) and its BPTT,
  of ``experiments/lstm_bi_stacked.py``;
- ``flagship``: the flagship model's train-mode forward with both in
  place of the production stem and recurrence.

The production model does not import them, exactly as in JAX
(``vistaocr_tpu/models/cnnlstm.py:110-114``,
``vistaocr_tpu/models/blstm.py:157-162``): ``ModelConfig`` has no switch
that selects them.
"""
