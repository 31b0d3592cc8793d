"""Training: TTUR optimizers and the LR schedule (state), the sequential G
then D step (train_step), checkpoints in the reference's naming
(checkpoint)."""
