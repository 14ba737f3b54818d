"""Training runtime of the PyTorch port: config, optimizer, schedules,
engine."""
