"""Model serialization."""
