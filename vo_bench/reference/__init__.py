"""The benchmark's plain reference: a frozen copy of the port's eager code (``config``,
``core``, ``ops``, ``frontend``, ``solve/ba``, the JAX key schedule and the host loop),
with the plain block extraction and ``torch.linalg.svd`` where the port launches its
kernels. It imports neither JAX, nor the JAX package, nor the port, and the port's later
changes do not reach it. It computes in float32 with TF32 off, as the configurations
state (``vo_bench/check.py::full_precision`` sets both flags around it).
"""
