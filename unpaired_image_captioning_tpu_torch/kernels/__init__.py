"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version: `lstm_cell` (fused LSTM step), `row_topk` (exact row
top-k), `transformer_decode` (incremental transformer decoder step),
`mha_train` (training attention, forward and backward) and `ln_train`
(training LayerNorm, forward and backward). `build` compiles `csrc/*.cu`
with nvcc at first use."""
