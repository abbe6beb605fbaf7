"""Training: schedules, the multi-group optimizer and the trainer loop."""
