"""The training UI (counterpart of ``deeplearning4j_tpu/ui/``; reference
``deeplearning4j-ui-parent``): the StatsListener, its storages, the UI
server with its remote router, and the JSON request handler every server
of the port builds on."""
from .stats import (StatsListener, StatsReport, StatsStorage, InMemoryStatsStorage,
                    FileStatsStorage, SqliteStatsStorage)
from .server import JsonRequestHandler, MAX_POST_BYTES, UIServer, RemoteUIStatsStorageRouter

__all__ = ["StatsListener", "StatsReport", "StatsStorage",
           "InMemoryStatsStorage", "FileStatsStorage", "SqliteStatsStorage",
           "UIServer", "RemoteUIStatsStorageRouter", "JsonRequestHandler", "MAX_POST_BYTES"]
