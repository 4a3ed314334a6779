"""PyTorch / CUDA port of preworld_tpu (inference and both train stages).

Mirrors the JAX package's layout (`ops/`, `geometry/`, `models/`, `data/`,
`losses/`, `metrics/`, `train/`, `utils/`). Imports torch, numpy, scipy
and PIL only; the
hand-written CUDA kernels in `csrc/` are built with nvcc at first use on a
CUDA tensor.
"""
