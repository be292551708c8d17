"""Networks, layers and their configuration."""
