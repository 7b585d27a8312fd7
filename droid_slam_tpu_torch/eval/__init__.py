"""Trajectory scoring of the port: Umeyama alignment and ATE."""
