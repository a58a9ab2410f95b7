"""The optimizer of training: the learning-rate schedules (``schedule``),
AdamW (``adamw``) and per-leaf int8 gradient compression with error
feedback (``grad_compress``)."""
