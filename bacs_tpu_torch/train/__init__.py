"""Training: the train state, optimizers and schedules, the step factory,
metrics and the continual task loop."""
