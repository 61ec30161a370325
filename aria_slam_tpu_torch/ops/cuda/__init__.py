"""Hand-written CUDA kernels for Hopper (sm_90a), one per Pallas kernel
of the JAX package (ops/pallas/), each beside its plain PyTorch version.

A wrapper runs the plain version for a CPU tensor and launches its
kernel for a CUDA tensor, or raises; there is no fallback between the
two. Each wrapper counts its launches in its `launches` attribute.
"""
