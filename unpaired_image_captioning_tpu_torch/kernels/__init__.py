"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version: `lstm_cell` (fused LSTM step) and `row_topk` (exact row
top-k). `build` compiles `csrc/*.cu` with nvcc at first use."""
