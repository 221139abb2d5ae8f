"""Device kernels for the relational hot path, as torch ops on tensors,
plus the hand-written CUDA kernels of ``csrc/`` behind their wrappers."""
