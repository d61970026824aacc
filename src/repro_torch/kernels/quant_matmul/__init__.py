from repro_torch.kernels.quant_matmul.ops import (fixed_dense,  # noqa: F401
                                                  fixed_dense_plain, fixed_dense_route,
                                                  fixed_window_head,
                                                  fixed_window_head_plain, quant_matmul,
                                                  quant_matmul_plain, quant_matmul_route)
