"""Training: advantage estimation, the PPO step, the fused iteration and
the learner."""
