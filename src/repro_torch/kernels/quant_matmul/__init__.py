from repro_torch.kernels.quant_matmul.ops import fixed_dense, fixed_dense_plain
