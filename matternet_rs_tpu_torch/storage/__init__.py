"""Persistence (twin of the reference's ``storage``): Parquet artifacts with
typed JSON metadata (:mod:`.parquet`) and the raw shard store
(:mod:`.shards`). The files are the reference's, so either package reads
what the other wrote. ``pyarrow`` is imported by :mod:`.parquet` only, so
the package and the shard store work without it."""


class StorageError(Exception):
    """A storage artifact is missing, inconsistent or cannot be written."""
