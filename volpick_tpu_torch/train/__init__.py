"""Training of the port: losses, schedules, EMA, checkpoints, the trainer and
the native export."""
