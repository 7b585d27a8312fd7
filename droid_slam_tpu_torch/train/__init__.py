"""Training of the port: losses, the train step, graphs and checkpoints."""
