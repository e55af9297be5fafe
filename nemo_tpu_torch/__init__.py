"""PyTorch/CUDA port of nemo_tpu (Hopper kernels written by hand).

The layout mirrors `nemo_tpu/` so that each module's counterpart sits at the
same path. The package imports torch and numpy only: never JAX and never
`nemo_tpu`.
"""

__version__ = "0.1.0"
