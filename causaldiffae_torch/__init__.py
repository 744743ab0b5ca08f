"""PyTorch/CUDA port of causaldiffae_tpu for NVIDIA Hopper (H100).

A package of its own beside the JAX package: it imports torch and numpy and
nothing of ``causaldiffae_tpu``. Module paths mirror the JAX package's
(``config``, ``diffusion/``, ``models/``, ``evals/``), public functions keep
its NHWC image layout and its head-major ``[q k v]`` attention interleave,
and module attribute names follow the reference torch ``state_dict`` keys.

The attention kernel lives in ``csrc/attention_fwd.cu`` (CUDA C++ for
sm_90a), is built with ``nvcc`` at first use and is bound with ctypes
(``ops/_build.py``, ``ops/attention.py``).
"""

__version__ = "0.1.0"
