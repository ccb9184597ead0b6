"""Host I/O off the engine's thread: the checkpoint writer
(``async_io``)."""

from .async_io import (ASYNC_IO_ENV, AsyncWriter, SyncWriter,
                       async_io_from_env, writer_from_config)

__all__ = ["ASYNC_IO_ENV", "AsyncWriter", "SyncWriter",
           "async_io_from_env", "writer_from_config"]
