"""Rule pack TN: fleet-tier tenant isolation.

Round 23 made the serving plane multi-tenant: serve/fleet.py's
PredictorPool owns every piece of per-tenant mutable state (the live
predictor, the host spill, the quality monitor, the invalidation
ledger) behind accessor methods, because the isolation guarantees the
fleet bench byte-checks — spill/restore bit-exactness, per-tenant
reload invisibility — hold only while every reader goes through the
pool's lock discipline.  TN001 keeps the rest of the serving plane from
reaching past those accessors.
"""

from __future__ import annotations

import ast
from typing import Iterator

from deeprest_tpu_torch.analysis.core import Finding, Project, Rule, register

# serve/fleet.py is the OWNER of the per-tenant state; everything else
# under serve/ must go through PoolEntry.predictor()/quality()/
# invalidations()/note_invalidation() or PredictorPool.resolve()/peek().
_OWNER = "fleet.py"
_TENANT_PREFIX = "_tenant_"


@register
class TN001TenantStateOutsideAccessor(Rule):
    id = "TN001"
    title = ("per-tenant mutable state reached outside a pool-entry "
             "accessor in the serving plane")
    guards = ("round 23: the fleet tier's isolation byte-checks (tenant A "
              "bit-identical under tenant B load, spill->restore "
              "bit-exact) hold because every per-tenant mutable — the "
              "predictor, the host spill, the quality monitor, the "
              "invalidation ledger — lives on ``_tenant_*`` attributes "
              "owned by serve/fleet.py and is read through accessor "
              "methods under the pool lock.  A direct ``._tenant_*`` "
              "access anywhere else in serve/ bypasses the lock and the "
              "LRU/restore bookkeeping: it can observe a half-spilled "
              "tree or stomp a reload mid-swap")

    # Scope: the serving plane only (the watchlist-by-directory shape of
    # OB001 — a name list would silently exempt new serve/ modules).
    HOT_DIRS = ("serve",)

    def _is_hot(self, rel: str) -> bool:
        parts = rel.replace("\\", "/").split("/")
        return (any(d in parts[:-1] for d in self.HOT_DIRS)
                and parts[-1] != _OWNER)

    def run(self, project: Project) -> Iterator[Finding]:
        for sf in project.files:
            if sf.tree is None or not self._is_hot(sf.rel):
                continue
            for node in sf.walk():
                if (isinstance(node, ast.Attribute)
                        and node.attr.startswith(_TENANT_PREFIX)):
                    yield sf.finding(
                        node, self.id,
                        f"direct {node.attr!r} access outside "
                        "serve/fleet.py: per-tenant mutable state is "
                        "owned by the pool and must be reached through "
                        "a PoolEntry accessor (predictor()/quality()/"
                        "invalidations()) or PredictorPool.resolve()/"
                        "peek(), which take the pool lock and keep the "
                        "LRU/spill bookkeeping honest")
