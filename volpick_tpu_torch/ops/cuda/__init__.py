"""Hand-written CUDA kernels (csrc/*.cu, built by ``_build``) and their plain
PyTorch twins. A wrapper runs its twin for CPU tensors and its kernel for CUDA
tensors."""
