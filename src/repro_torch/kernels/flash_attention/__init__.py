"""Flash attention: CUDA forward kernel (csrc/flash_fwd.cu), its wrapper
and its plain PyTorch version."""
