"""A copy of ``one_class_ffm_tpu/data/__init__.py`` (the port imports
nothing of the JAX package); ``tests/test_torch_copies.py`` holds the
two equal."""

from .dataset import (
    RawData,
    FieldData,
    Interactions,
    read_data,
    split_fields,
    trans_y,
    PaddedFields,
    pad_fields,
    pad_labels,
)

__all__ = [
    "RawData",
    "FieldData",
    "Interactions",
    "read_data",
    "split_fields",
    "trans_y",
    "PaddedFields",
    "pad_fields",
    "pad_labels",
]
