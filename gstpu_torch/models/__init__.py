"""The Gaussian point-cloud model."""
