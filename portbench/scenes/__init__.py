"""Meshes and frames the benchmark makes from the seed."""
