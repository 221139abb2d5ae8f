"""Connectors behind the SPI in :mod:`presto_tpu_torch.connectors.api`
(tpch, tpcds, memory, blackhole, system, information_schema)."""

from presto_tpu_torch.connectors.api import (  # noqa: F401
    ColumnMetadata, Connector, ConnectorRegistry, PageSource, Split,
    TableHandle, TableSchema,
)
