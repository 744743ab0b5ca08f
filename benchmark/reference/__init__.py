"""The plain float32 PyTorch reference that decides ``correct``.

It imports neither JAX, nor the JAX package, nor anything of the measured
port: only torch and numpy.
"""
