"""Training: CTC and RNNT losses, the optimizers and schedules, the trainers."""
