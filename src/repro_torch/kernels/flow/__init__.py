"""The flow-level simulator's hot loops: four CUDA kernels
(csrc/flow.cu), their wrappers (flow.py) and their plain PyTorch versions
(ref.py), called by ``core/compiled_flow.py``."""
