"""Host utilities: logging and named timers."""
