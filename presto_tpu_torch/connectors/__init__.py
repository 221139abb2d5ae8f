"""Connectors behind the SPI in :mod:`presto_tpu_torch.connectors.api`
(this slice ships the tpch generator)."""

from presto_tpu_torch.connectors.api import (  # noqa: F401
    ColumnMetadata, Connector, ConnectorRegistry, PageSource, Split,
    TableHandle, TableSchema,
)
