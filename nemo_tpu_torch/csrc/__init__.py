"""Hand-written CUDA kernels for Hopper (`*.cu`) and their build and loader."""
