"""ctypes bindings for the native C++ CSV loader (native/csv_loader.cpp).

The port of sqlrs_tpu/storage/native_loader.py. read_csv_native() has the
same contract as storage/csv.read_csv_file, which stays the semantics source
of truth and the path taken when no compiler is available. The env var
SQLRS_TPU_NATIVE_CSV=0 turns the native path off.

The library is built from the repository's source at first use into
build/native/ at the repository root (utils/native_build.py: a file name
that carries a hash of the source and the flags, a locked build and an
atomic rename). Importing this module needs no compiler. VARCHAR cells
intern through this package's dictionary (data/strings.GLOBAL_STRINGS), in
column order then row order, as read_csv_file interns them.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from sqlrs_tpu_torch.data.strings import GLOBAL_STRINGS
from sqlrs_tpu_torch.errors import StorageError
from sqlrs_tpu_torch.storage.csv import CsvConfig
from sqlrs_tpu_torch.storage.memory import DataTable
from sqlrs_tpu_torch.types import LogicalType
from sqlrs_tpu_torch.utils import native_build

SOURCE = os.path.join(native_build.NATIVE_DIR, "csv_loader.cpp")

_TYPE_MAP = {
    0: LogicalType.BIGINT,
    1: LogicalType.DOUBLE,
    2: LogicalType.BOOLEAN,
    3: LogicalType.DATE,
    4: LogicalType.VARCHAR,
}
# the loader's buffer dtype per type code (booleans are one byte each)
_NP_MAP = {0: np.int64, 1: np.float64, 2: np.uint8, 3: np.int32}

_lock = threading.Lock()
_lib = None
_lib_failed = False


def library_path() -> str:
    """Where the build of the current source and flags lives."""
    return native_build.library_path(SOURCE, "libsqlrs_csv")


def _load_lib():
    global _lib, _lib_failed
    if _lib is not None or _lib_failed:
        return _lib
    with _lock:
        if _lib is not None or _lib_failed:
            return _lib
        if os.environ.get("SQLRS_TPU_NATIVE_CSV", "1") == "0":
            _lib_failed = True
            return None
        try:
            lib = ctypes.CDLL(native_build.build(SOURCE, "libsqlrs_csv"))
        except Exception:
            _lib_failed = True
            return None
        lib.csv_load.restype = ctypes.c_void_p
        lib.csv_load.argtypes = [ctypes.c_char_p, ctypes.c_char, ctypes.c_int]
        lib.csv_error.restype = ctypes.c_char_p
        lib.csv_error.argtypes = [ctypes.c_void_p]
        lib.csv_num_rows.restype = ctypes.c_int64
        lib.csv_num_rows.argtypes = [ctypes.c_void_p]
        lib.csv_num_cols.restype = ctypes.c_int64
        lib.csv_num_cols.argtypes = [ctypes.c_void_p]
        lib.csv_col_name.restype = ctypes.c_char_p
        lib.csv_col_name.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.csv_col_type.restype = ctypes.c_int32
        lib.csv_col_type.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.csv_col_data.restype = ctypes.c_void_p
        lib.csv_col_data.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.csv_col_valid.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.csv_col_valid.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.csv_col_str_bytes.restype = ctypes.c_void_p
        lib.csv_col_str_bytes.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.csv_col_str_offsets.restype = ctypes.POINTER(ctypes.c_int64)
        lib.csv_col_str_offsets.argtypes = [ctypes.c_void_p, ctypes.c_int64]
        lib.csv_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def native_available() -> bool:
    return _load_lib() is not None


def read_csv_native(path: str, config: CsvConfig | None = None) -> DataTable:
    lib = _load_lib()
    if lib is None:
        raise StorageError("native csv loader unavailable")
    config = config or CsvConfig()
    handle = lib.csv_load(
        path.encode(), config.delimiter.encode()[:1], int(config.has_header)
    )
    try:
        err = lib.csv_error(handle)
        if err:
            raise StorageError(f"native csv {path!r}: {err.decode()}")
        n = lib.csv_num_rows(handle)
        ncols = lib.csv_num_cols(handle)
        names, types, datas, valids = [], [], [], []
        for i in range(ncols):
            names.append(lib.csv_col_name(handle, i).decode())
            tc = lib.csv_col_type(handle, i)
            types.append(_TYPE_MAP[tc])
            valid = np.ctypeslib.as_array(lib.csv_col_valid(handle, i), (n,)).astype(
                np.bool_
            )
            if tc == 4:  # utf8 -> intern codes
                offs = np.ctypeslib.as_array(
                    lib.csv_col_str_offsets(handle, i), (n + 1,)
                ).copy()
                raw = ctypes.string_at(lib.csv_col_str_bytes(handle, i), int(offs[-1]))
                data = GLOBAL_STRINGS.intern_each(
                    [raw[offs[r] : offs[r + 1]].decode("utf-8") for r in range(n)]
                )
            else:
                ptr = ctypes.cast(
                    lib.csv_col_data(handle, i),
                    ctypes.POINTER(
                        np.ctypeslib.as_ctypes_type(np.dtype(_NP_MAP[tc]))
                    ),
                )
                data = np.ctypeslib.as_array(ptr, (n,)).copy()
                if tc == 2:
                    data = data.astype(np.bool_)
            datas.append(data)
            valids.append(valid)
        table = DataTable(names, types)
        table.append_numpy(datas, valids)
        return table
    finally:
        lib.csv_free(handle)
