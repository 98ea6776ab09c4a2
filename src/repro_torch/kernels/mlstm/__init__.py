"""Chunkwise mLSTM: CUDA forward kernel (csrc/mlstm_fwd.cu), its wrapper,
its plain PyTorch versions and the autograd op."""
