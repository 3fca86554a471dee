"""Batched torch ops over masked metric windows, and the CUDA kernels of
the scoring path (`kernels.py`, sources in `csrc/`)."""
