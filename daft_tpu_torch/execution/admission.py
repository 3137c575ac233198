"""Tenant identity (the tenant lines of ``daft_tpu/execution/admission.py``).

The result cache accounts its bytes per tenant and evicts tenant-fairly
(``plancache.py``), so every query carries one: the explicit argument, else
the calling context's ``set_tenant``, else ``DAFT_TENANT``, else
``DEFAULT_TENANT``. The admission controller itself (per-tenant quotas,
the bounded queue, the shed ladder, ``get_controller``), the top level's
``set_tenant`` / ``current_tenant`` and the policies are ROADMAP A.8.4.
"""

from __future__ import annotations

import contextvars
from typing import Optional

#: Tenant used when nothing is configured: ``set_tenant()`` not called and
#: ``DAFT_TENANT`` unset.
DEFAULT_TENANT = "default"

_tenant_var: contextvars.ContextVar[Optional[str]] = \
    contextvars.ContextVar("daft_torch_tenant", default=None)


def set_tenant(tenant: Optional[str]) -> None:
    """Set the calling context's tenant identity. Contextvar-scoped:
    concurrent serving threads each carry their own. ``None`` clears back
    to ``DAFT_TENANT`` / the default."""
    _tenant_var.set(tenant)


def current_tenant() -> str:
    return resolve_tenant(None)


def resolve_tenant(tenant: Optional[str]) -> str:
    """Explicit arg > ``set_tenant()`` contextvar > ``DAFT_TENANT`` env >
    ``default``."""
    if tenant:
        return tenant
    ctx_tenant = _tenant_var.get()
    if ctx_tenant:
        return ctx_tenant
    from daft_tpu_torch.config import daft_env

    return daft_env("DAFT_TENANT") or DEFAULT_TENANT
