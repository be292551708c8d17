"""Training health of the port (``health.py``)."""
