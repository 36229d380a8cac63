from repro_torch.train.compressed import fig5_rows, train_compressed  # noqa: F401
from repro_torch.train.dp_sim import PSTrainer  # noqa: F401
