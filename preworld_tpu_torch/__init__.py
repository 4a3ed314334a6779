"""PyTorch / CUDA port of preworld_tpu (inference slice).

Mirrors the JAX package's layout (`ops/`, `geometry/`, `models/`, `data/`,
`utils/`). Imports torch and numpy only; the hand-written CUDA kernels in
`csrc/` are built with nvcc at first use on a CUDA tensor.
"""
