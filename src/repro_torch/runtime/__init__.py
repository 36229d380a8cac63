"""Step machinery for the PS training loop (see ``step.py``)."""
