"""AdamW as three multi-tensor CUDA kernels (csrc/adamw.cu) and their
wrapper (adamw.py), called by ``train/optimizer.py`` on CUDA tensors; its
chunked PyTorch code is their plain version."""
