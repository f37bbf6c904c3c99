"""AdamW and learning-rate schedules."""
from repro_torch.optim.adamw import AdamW, global_norm  # noqa: F401
from repro_torch.optim.schedule import constant, cosine_warmup  # noqa: F401
