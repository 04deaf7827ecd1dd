"""Training on the fused path: config, schedules, metrics, the train loop and checkpoints."""
