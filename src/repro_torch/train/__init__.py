"""Step-level supervision shared with the streaming driver: the step
watchdog (``train.watchdog``)."""
