"""Hand-written CUDA kernels of the convolution and their plain twins."""
