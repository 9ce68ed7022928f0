"""herro_tpu_torch — the PyTorch/CUDA port of herro_tpu for NVIDIA Hopper.

The same pipeline as ``herro_tpu`` (overlaps -> window pileups -> transformer
scoring of supported columns -> consensus decoding), with the device step in
PyTorch and its hot kernels written by hand in CUDA C++ for ``sm_90a``
(``csrc/``). The package imports neither JAX nor ``herro_tpu``: the host layer
it shares with the reference is carried as its own copy.
"""

__version__ = "0.1.0"
