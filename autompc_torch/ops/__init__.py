"""Numerical routines and the CUDA kernel wrappers (``cuda_*``)."""
