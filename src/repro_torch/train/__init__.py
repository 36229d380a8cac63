from repro_torch.train.compressed import fig5_rows, train_compressed  # noqa: F401
from repro_torch.train.dp_sim import PSTrainer  # noqa: F401
from repro_torch.train.lm import lm_config, lm_trainer, train_lm  # noqa: F401
from repro_torch.train.serve import serve  # noqa: F401
from repro_torch.train.tta import run_tta, train_tta  # noqa: F401
