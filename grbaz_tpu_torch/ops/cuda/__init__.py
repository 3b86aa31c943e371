"""Hand-written Hopper kernels and their plain PyTorch twins.

Every wrapper launches its CUDA kernel for a tensor on the card (or
raises) and runs its plain version for a tensor on the CPU. Each wrapper
counts its kernel launches in its ``launches`` attribute.
"""
