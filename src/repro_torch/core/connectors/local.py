"""LocalConnector: host-process executor resources (the paper's management-
node-adjacent containers / the "cloud VM" stand-in for CPU work)."""
from __future__ import annotations

import time
from typing import Any, Dict, List, Optional

from repro_torch.core.connector import (Connector, ConnectorCopyKind, ObjectStore,
                                  ResourceInfo)


class LocalConnector(Connector):
    """config: {services: {<name>: {replicas: N, cores: C, memory_gb: M}},
                deploy_delay_s: float, shared_store: bool}"""

    def __init__(self, name: str, config: Optional[dict] = None):
        super().__init__(name, config)
        self._resources: Dict[str, ResourceInfo] = {}
        self._stores: Dict[str, ObjectStore] = {}
        self._shared: Optional[ObjectStore] = None

    def deploy(self) -> None:
        delay = float(self.config.get("deploy_delay_s", 0.0))
        if delay:
            time.sleep(delay)
        services = self.config.get("services", {"default": {"replicas": 1}})
        if self.config.get("shared_store"):
            self._shared = ObjectStore(f"{self.name}:shared")
        for svc, scfg in services.items():
            for i in range(int(scfg.get("replicas", 1))):
                rname = f"{self.name}/{svc}/{i}"
                self._resources[rname] = ResourceInfo(
                    rname, svc, cores=int(scfg.get("cores", 1)),
                    memory_gb=float(scfg.get("memory_gb", 4.0)))
                self._stores[rname] = self._shared or ObjectStore(rname)
        self.deployed = True

    def undeploy(self) -> None:
        self._resources.clear()
        self._stores.clear()
        self.deployed = False

    def get_available_resources(self, service: str) -> List[str]:
        return [r for r, info in self._resources.items()
                if info.service == service]

    def resource_info(self, resource: str) -> ResourceInfo:
        return self._resources[resource]

    def store(self, resource: str) -> ObjectStore:
        return self._stores[resource]

    def shared_data_space(self) -> bool:
        return self._shared is not None

    def run(self, resource: str, command: Any,
            environment: Optional[Dict[str, str]] = None,
            workdir: Optional[str] = None,
            capture_output: bool = False) -> Any:
        if resource not in self._resources:
            raise KeyError(f"unknown resource {resource}")
        ctx = {"resource": resource, "connector": self,
               "environment": environment or {}, "mesh": None}
        out = command(ctx)
        return out if capture_output else None
