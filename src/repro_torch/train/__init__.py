from repro_torch.train.dp_sim import PSTrainer  # noqa: F401
