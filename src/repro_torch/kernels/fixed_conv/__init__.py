from repro_torch.kernels.fixed_conv.ops import (fixed_conv2d, fixed_conv2d_plain,
                                                fixed_maxpool2x2,
                                                fixed_maxpool2x2_plain,
                                                fixed_sigmoid, fixed_sigmoid_plain,
                                                fixed_smallnet, fixed_smallnet_plain,
                                                smallnet_fits)
