"""Optimization: the network-level updater and gradient normalization."""
