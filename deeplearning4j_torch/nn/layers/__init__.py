"""Layer implementations; importing this package registers all of them."""
from .base import LayerImpl, impl_for, implements  # noqa: F401
from . import (attention, convolution, feedforward, moe, normalization,  # noqa: F401
               output, pooling, recurrent)

__all__ = ["LayerImpl", "impl_for", "implements"]
