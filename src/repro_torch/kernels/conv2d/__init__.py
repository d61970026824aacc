from repro_torch.kernels.conv2d.ops import (conv2d, conv2d_plain, conv2d_tile,  # noqa: F401
                                            float_smallnet, float_smallnet_fits,
                                            float_smallnet_plain, float_sweep_stage,
                                            float_sweep_stage_plain, float_window_head,
                                            float_window_head_plain)
