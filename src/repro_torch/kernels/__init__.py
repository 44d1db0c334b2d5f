"""The Hopper kernels (CUDA C++ under ``csrc/``), their wrappers, plain
PyTorch versions and launch counters."""
