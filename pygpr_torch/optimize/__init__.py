"""Hyperparameter optimizers."""
