"""Training engine of the port: losses, optimizers, schedules, EMA, the train
and validation steps, and ``MouseModel``."""
