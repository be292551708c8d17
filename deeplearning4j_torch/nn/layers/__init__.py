"""Layer implementations; importing this package registers all of them."""
from .base import LayerImpl, impl_for, implements  # noqa: F401
from . import (attention, convolution, feedforward, moe, normalization,  # noqa: F401
               objdetect, output, pooling, recurrent, variational, wrapper)

__all__ = ["LayerImpl", "impl_for", "implements"]
