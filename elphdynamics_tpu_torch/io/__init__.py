"""Input, output and checkpoints of the driver."""
