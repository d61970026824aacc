from repro_torch.kernels.quant_matmul.ops import (fixed_dense,  # noqa: F401
                                                  fixed_dense_plain, quant_matmul,
                                                  quant_matmul_plain, quant_matmul_route)
