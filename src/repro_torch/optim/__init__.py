"""The optimizer of training: the learning-rate schedules (``schedule``)
and AdamW (``adamw``)."""
