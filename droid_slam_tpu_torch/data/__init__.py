"""Input data of the port: the synthetic sequences of the evaluation protocol."""
