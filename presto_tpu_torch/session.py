"""Sessions and access control.

The reference hangs per-query state off ``Session`` (identity, catalog,
schema) and checks table access at analysis time through the
SystemAccessControl SPI, with the session identity.  Session properties
(SET SESSION), rule-based access control and transactions come with the
statements that use them (ROADMAP A4).
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass
class Session:
    """Per-connection context (Session.java role)."""

    user: str = "user"
    catalog: str = "tpch"
    schema: Optional[str] = None


class AccessDeniedError(PermissionError):
    pass


class AccessControl:
    """SystemAccessControl SPI surface used by the SELECT path."""

    def check_can_select(self, user: str, catalog: str, table: str) -> None:
        raise NotImplementedError


class AllowAllAccessControl(AccessControl):
    def check_can_select(self, user, catalog, table):
        pass
