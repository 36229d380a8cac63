"""Launchers: the sharded path's meshes (``mesh.py``) and the training
entry point (``train.py``, ``python -m repro_torch.launch.train``)."""
