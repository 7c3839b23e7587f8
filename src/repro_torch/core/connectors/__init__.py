from typing import Dict, Optional

from repro_torch.core.connector import Connector
from repro_torch.core.connectors.local import LocalConnector
from repro_torch.core.connectors.mesh import MeshConnector
from repro_torch.core.connectors.multipod import MultiPodConnector
from repro_torch.core.connectors.simcluster import SimClusterConnector

CONNECTOR_TYPES = {
    "local": LocalConnector,
    "mesh": MeshConnector,
    "multipod": MultiPodConnector,
    "simcluster": SimClusterConnector,
}


def make_connector(name: str, type_: str, config: dict):
    try:
        cls = CONNECTOR_TYPES[type_]
    except KeyError:
        raise KeyError(f"unknown connector type {type_!r}; "
                       f"known: {sorted(CONNECTOR_TYPES)}") from None
    return cls(name, config)


# ---------------------------------------------------------------------------
# External sites (``external: true`` models).  In the paper these are
# user-managed deployments that outlive any one StreamFlow driver; here the
# same semantics come from a process-global registry the DeploymentManager
# attaches to instead of deploying.  A driver crash (or undeploy_all on its
# exception path) leaves the site — and the tokens in its stores — running,
# which is exactly what ``Executor.resume`` re-attaches to.
# ---------------------------------------------------------------------------

_EXTERNAL_SITES: Dict[str, Connector] = {}


def start_external_site(name: str, type_: str, config: dict) -> Connector:
    """Start (or return the already-running) user-managed site ``name``."""
    conn = _EXTERNAL_SITES.get(name)
    if conn is None or not conn.deployed:
        conn = make_connector(name, type_, config)
        conn.deploy()
        _EXTERNAL_SITES[name] = conn
    return conn


def get_external_site(name: str) -> Optional[Connector]:
    conn = _EXTERNAL_SITES.get(name)
    return conn if conn is not None and conn.deployed else None


def stop_external_site(name: Optional[str] = None):
    """Tear down one external site (or all of them, for test isolation)."""
    names = [name] if name is not None else list(_EXTERNAL_SITES)
    for n in names:
        conn = _EXTERNAL_SITES.pop(n, None)
        if conn is not None and conn.deployed:
            conn.undeploy()
