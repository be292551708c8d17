"""Layer implementations; importing this package registers all of them."""
from .base import LayerImpl, impl_for, implements  # noqa: F401
from . import attention, feedforward, normalization, output, recurrent  # noqa: F401

__all__ = ["LayerImpl", "impl_for", "implements"]
