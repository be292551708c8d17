"""``python -m deeplearning4j_torch``: the operational CLI (``main.py``)."""
from .main import main

if __name__ == "__main__":
    raise SystemExit(main())
