from sqlrs_tpu_torch.data.batch import Column, DeviceBatch, Schema, SchemaField
from sqlrs_tpu_torch.data.strings import GLOBAL_STRINGS, StringDictionary

__all__ = [
    "Column",
    "DeviceBatch",
    "Schema",
    "SchemaField",
    "StringDictionary",
    "GLOBAL_STRINGS",
]
