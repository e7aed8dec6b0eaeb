"""Hand-written CUDA kernels for Hopper (sm_90a), each beside its plain
PyTorch version: `lstm_cell` (fused LSTM step), `row_topk` (exact row
top-k, k <= 16), `chunked_topk` (exact row top-k, 16 < k <= 64),
`transformer_decode` (incremental transformer decoder step), `mha_train`
(training attention, forward and backward), `ln_train` (training
LayerNorm, forward and backward), `layer_train` (whole training layers),
`additive_attention` (additive attention, one query or K beams, and the
fused att1 -> lstm1 -> att2 decode step), `image` (the image front end:
bilinear resize and normalisation of uint8 images) and `lstm_block` (the
timestep-blocked LSTM chain, forward and backward). `build` compiles
`csrc/*.cu` with nvcc at first use."""
