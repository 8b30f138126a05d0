"""Greedy decode paths and the hand-written CUDA kernels they launch."""
