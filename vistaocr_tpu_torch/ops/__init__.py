"""Device ops of the port: preprocess/augment, resize, the LSTM and CTC
kernel wrappers (with their plain versions) and the plain CTC.

Nothing here builds or loads a kernel at import time: ``ops/_build.py``
compiles ``csrc/`` on the first launch on a CUDA tensor.
"""
