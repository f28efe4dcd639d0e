"""Kernels and their plain versions, with the tensor ops around them."""
