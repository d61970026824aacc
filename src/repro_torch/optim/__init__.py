from repro_torch.optim.adam import (AdamConfig, AdamState, adam_init, adam_update,
                                    clip_by_global_norm, cosine_schedule)

__all__ = ["AdamConfig", "AdamState", "adam_init", "adam_update", "clip_by_global_norm",
           "cosine_schedule"]
