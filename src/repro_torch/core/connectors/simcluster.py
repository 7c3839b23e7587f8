"""SimClusterConnector: failure/straggler-injecting wrapper for FT drills.

Wraps any inner connector type and injects, per (step-ish command tag,
attempt): crashes, stragglers (sleep multipliers), site-down intervals.
This is how fault-tolerance behaviour is tested without real hardware —
the executor cannot tell it apart from a flaky site.
"""
from __future__ import annotations

import threading
import time
from typing import Any, Dict, List, Optional

from repro_torch.core.connector import Connector, ObjectStore, ResourceInfo
from repro_torch.core.connectors.local import LocalConnector
from repro_torch.core.connectors.mesh import MeshConnector


class SimFault(Exception):
    pass


class SimClusterConnector(Connector):
    """config:
        inner: {type: local|mesh, config: {...}}
        fail: [{match: "/chains/1", attempts: [0]}]      # crash on attempt 0
        straggle: [{match: "/count", factor: 5.0, attempts: [0]}]
        down_after: null | seconds                        # site dies entirely
    """

    def __init__(self, name: str, config: Optional[dict] = None):
        super().__init__(name, config)
        inner_cfg = (config or {}).get("inner", {"type": "local", "config": {}})
        inner_type = inner_cfg.get("type", "local")
        cls = {"local": LocalConnector, "mesh": MeshConnector}[inner_type]
        self._inner = cls(name + ".inner", inner_cfg.get("config", {}))
        self._attempts: Dict[str, int] = {}
        self._lock = threading.Lock()
        self._deploy_time: Optional[float] = None
        self.injected: List[str] = []            # audit log for tests

    # -- lifecycle ------------------------------------------------------------
    def deploy(self) -> None:
        self._inner.deploy()
        self._deploy_time = time.time()
        self.deployed = True

    def undeploy(self) -> None:
        self._inner.undeploy()
        self.deployed = False

    # -- pass-through -----------------------------------------------------------
    def get_available_resources(self, service: str) -> List[str]:
        return self._inner.get_available_resources(service)

    def services(self) -> List[str]:
        return self._inner.services()

    def resource_info(self, resource: str) -> ResourceInfo:
        return self._inner.resource_info(resource)

    def store(self, resource: str) -> ObjectStore:
        return self._inner.store(resource)

    def shared_data_space(self) -> bool:
        return self._inner.shared_data_space()

    def ping(self, resource: Optional[str] = None) -> bool:
        if self._site_down():
            return False
        return self._inner.ping(resource)

    def _site_down(self) -> bool:
        d = self.config.get("down_after")
        return (d is not None and self._deploy_time is not None
                and time.time() - self._deploy_time >= float(d))

    # -- fault injection ---------------------------------------------------------
    def _tag_of(self, command: Any) -> str:
        return getattr(command, "tag", repr(command))

    def run(self, resource: str, command: Any,
            environment: Optional[Dict[str, str]] = None,
            workdir: Optional[str] = None,
            capture_output: bool = False) -> Any:
        if self._site_down():
            raise SimFault(f"site {self.name} is down")
        tag = self._tag_of(command)
        with self._lock:
            attempt = self._attempts.get(tag, 0)
            self._attempts[tag] = attempt + 1
        for rule in self.config.get("fail", []):
            if rule["match"] in tag and attempt in rule.get("attempts", [0]):
                self.injected.append(f"fail:{tag}:{attempt}")
                raise SimFault(f"injected failure for {tag} attempt {attempt}")
        for rule in self.config.get("straggle", []):
            if rule["match"] in tag and attempt in rule.get("attempts", [0]):
                self.injected.append(f"straggle:{tag}:{attempt}")
                delay = float(rule.get("seconds", 0.0))
                if not delay:
                    delay = float(rule.get("factor", 5.0)) * 0.05
                deadline = time.time() + delay
                cancel = environment.get("__cancel__") if environment else None
                while time.time() < deadline:
                    if cancel is not None and cancel.is_set():
                        raise SimFault(f"straggler {tag} cancelled")
                    time.sleep(0.005)
        return self._inner.run(resource, command, environment, workdir,
                               capture_output)
