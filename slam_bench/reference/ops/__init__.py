"""Geometry, correlation and bundle-adjustment ops of the port."""
