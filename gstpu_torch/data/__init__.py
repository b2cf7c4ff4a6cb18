"""Datasets: the NeRF-synthetic loader."""
