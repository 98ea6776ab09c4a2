"""Mamba2 SSD chunk scan: CUDA forward kernel (csrc/ssd_fwd.cu), its
wrapper, its plain PyTorch versions and the autograd op."""
