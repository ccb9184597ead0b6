"""Models with a device form for the port's engine."""
