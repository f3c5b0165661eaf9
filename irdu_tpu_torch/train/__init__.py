"""The YAML-driven trainer (counterpart: ``irdu_tpu/train``): schedules,
the flagship loss and its train and distillation steps, checkpoints with
auto-resume, and the loop. ``python -m irdu_tpu_torch.train --config ...``."""
