"""Training: the train state, optimizers and schedules, and the step factory."""
