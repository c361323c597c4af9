"""Runs over several ranks on ``torch.distributed``: ``distributed`` (joining
the run, the count-sum), ``mesh`` (the ('data', 'model') mesh, row sharding,
the model group's all-gather) and ``launch`` (ranks of one job from Python)."""
