"""Device ops of the port: preprocess, resize, the LSTM kernel wrapper.

Nothing here builds or loads a kernel at import time: ``ops/_build.py``
compiles ``csrc/`` on the first launch on a CUDA tensor.
"""
