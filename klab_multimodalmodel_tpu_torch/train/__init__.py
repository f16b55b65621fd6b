"""Training: optimizer, schedules and the single-device step."""
