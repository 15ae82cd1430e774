"""Kernels of the port: hand-written CUDA for Hopper (``csrc/``), their
plain PyTorch versions (``ref``), and dispatch by tensor device (``ops``)."""
