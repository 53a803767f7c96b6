"""The benchmark's plain reference: the S³ refinement, exact k nearest
neighbours and the inverse-distance export in plain PyTorch, float64.  It
imports nothing of the program and nothing of JAX."""
