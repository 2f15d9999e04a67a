"""The training stack of the port (``repro.training``): data, AdamW, the
train / eval / distillation steps and checkpoints."""
from repro_torch.training.checkpoint import restore, save
from repro_torch.training.data import DataConfig, batch_at, stream
from repro_torch.training.optimizer import (AdamWConfig, AdamWState, adamw_update,
                                            global_norm, init_adamw, lr_schedule)
from repro_torch.training.train_step import (cross_entropy, make_distill_step,
                                             make_eval_step, make_loss_fn,
                                             make_train_step)
