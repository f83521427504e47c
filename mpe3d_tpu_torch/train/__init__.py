"""Training: the lifter's dataset and trainer, matcher scenes, checkpoints."""
