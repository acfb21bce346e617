"""Plain PyTorch primitives and the hand-written CUDA kernels' wrappers."""
