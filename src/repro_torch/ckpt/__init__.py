from repro_torch.ckpt.checkpoint import (available_steps, latest_step,
                                         reshard, restore, save, save_async)
