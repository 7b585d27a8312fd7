"""Networks of the port: encoders, update operator, parameter carry-over."""
