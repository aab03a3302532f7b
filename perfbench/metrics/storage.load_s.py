"""storage.load_s (layer: storage): host seconds of the engine's table
import (storage.memory.import_tables: interning included) and the first
scan of every table, which copies it to the device."""


def read(run):
    return run.load_s
