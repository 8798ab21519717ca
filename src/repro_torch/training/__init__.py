"""Training: the synthetic data pipeline, AdamW with its schedules, the
train step and step-atomic checkpoints (the reference's `repro.training`)."""
