"""MeshConnector: one accelerator site (a pod slice) as a deployment unit.

The declarative config mirrors the paper's model-description files: a mesh
topology plus named services whose replicas are sub-slices.  R1 maps onto
the hardware exactly: a slice is gang-allocated atomically.

The *declared* topology is validated and recorded (it feeds the scheduler's
capability checks and the dry run), while the *runtime* uses the device
that exists: one CUDA device per site, which its replicas share.  The
config's optional ``device`` names it (``"cpu"`` for a run on the host, as
the tests do; ``"cuda:1"`` for another card); without it the site runs on
the GPU, and deploying raises when there is none.  No process group and no
``DeviceMesh`` is built: one card has no use for them.
"""
from __future__ import annotations

import math
import time
from typing import Any, Dict, List, Optional

import torch

from repro_torch.core.connector import Connector, ObjectStore, ResourceInfo
from repro_torch.device import resolve_device


class MeshConnector(Connector):
    """config:
        topology: {data: 16, model: 16}        # declared production shape
        services: {trainer: {replicas: 1, cores: 8, memory_gb: 64}}
        deploy_delay_s: 0.0
        shared_store: true                     # pod-local shared filesystem
        device: cuda | cuda:<i> | cpu          # runtime device (default cuda)
        model_axis: 1                          # accepted; no mesh is built
    """

    def __init__(self, name: str, config: Optional[dict] = None):
        super().__init__(name, config)
        self._resources: Dict[str, ResourceInfo] = {}
        self._stores: Dict[str, ObjectStore] = {}
        self._devices: Dict[str, torch.device] = {}
        self._shared: Optional[ObjectStore] = None

    # -- declared (production) topology --------------------------------------
    def declared_topology(self) -> Dict[str, int]:
        return dict(self.config.get("topology", {"data": 1, "model": 1}))

    def declared_chips(self) -> int:
        return math.prod(self.declared_topology().values())

    # -- lifecycle -------------------------------------------------------------
    def deploy(self) -> None:
        delay = float(self.config.get("deploy_delay_s", 0.0))
        if delay:
            time.sleep(delay)
        # one runtime device per site (a pod slice IS one physical mesh);
        # replicas share it
        site_device = resolve_device(self.config.get("device"))
        if self.config.get("shared_store", True):
            self._shared = ObjectStore(f"{self.name}:shared")
        services = self.config.get("services", {"default": {"replicas": 1}})
        for svc, scfg in services.items():
            for i in range(int(scfg.get("replicas", 1))):
                rname = f"{self.name}/{svc}/{i}"
                self._resources[rname] = ResourceInfo(
                    rname, svc, cores=int(scfg.get("cores", 8)),
                    memory_gb=float(scfg.get("memory_gb", 64.0)))
                self._stores[rname] = self._shared or ObjectStore(rname)
                self._devices[rname] = site_device
        self.deployed = True

    def undeploy(self) -> None:
        self._resources.clear()
        self._stores.clear()
        self._devices.clear()
        self.deployed = False

    # -- discovery ---------------------------------------------------------------
    def get_available_resources(self, service: str) -> List[str]:
        return [r for r, info in self._resources.items()
                if info.service == service]

    def resource_info(self, resource: str) -> ResourceInfo:
        return self._resources[resource]

    def store(self, resource: str) -> ObjectStore:
        return self._stores[resource]

    def shared_data_space(self) -> bool:
        return self._shared is not None

    def device(self, resource: str) -> torch.device:
        return self._devices[resource]

    # -- execution ------------------------------------------------------------------
    def run(self, resource: str, command: Any,
            environment: Optional[Dict[str, str]] = None,
            workdir: Optional[str] = None,
            capture_output: bool = False) -> Any:
        if resource not in self._resources:
            raise KeyError(f"unknown resource {resource}")
        dev = self._devices[resource]
        ctx = {"resource": resource, "connector": self,
               "environment": environment or {},
               "device": dev,
               "declared_topology": self.declared_topology()}
        if dev.type == "cuda":
            # the current device is per thread, and the executor's
            # invocations run on a pool of threads
            with torch.cuda.device(dev):
                out = command(ctx)
        else:
            out = command(ctx)
        return out if capture_output else None
