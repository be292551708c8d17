"""Datasets: containers, iterators, the prefetch pipeline of the fit loops,
shape bucketing and normalizers (counterparts of
``deeplearning4j_tpu/datasets/{dataset,iterators,prefetch,bucketing,normalizers}.py``)."""
from .dataset import (DataSet, DataSetIterator, ExistingDataSetIterator,  # noqa: F401
                      ListDataSetIterator, MultiDataSet)
from .iterators import (AsyncDataSetIterator, BenchmarkDataSetIterator,  # noqa: F401
                        EarlyTerminationDataSetIterator, MultipleEpochsIterator)
from .prefetch import PrefetchDataSetIterator, PrefetchIterator, wrap_for_training  # noqa: F401
from .bucketing import ShapeBucketingDataSetIterator  # noqa: F401
from .normalizers import (ImagePreProcessingScaler, NormalizerMinMaxScaler,  # noqa: F401
                          NormalizerStandardize)
