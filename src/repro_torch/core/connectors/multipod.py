"""MultiPodConnector: a MeshConnector whose declared topology carries the
"pod" DCN axis.  Runtime behaviour equals MeshConnector (graceful host
degrade); the declared (pod, data, model) shape is what the dry-run lowers
against and what the scheduler's capability checks see."""
from __future__ import annotations

from typing import Dict, Optional

from repro_torch.core.connectors.mesh import MeshConnector


class MultiPodConnector(MeshConnector):
    def __init__(self, name: str, config: Optional[dict] = None):
        config = dict(config or {})
        config.setdefault("topology", {"pod": 2, "data": 16, "model": 16})
        if "pod" not in config["topology"]:
            raise ValueError("multipod connector requires a 'pod' axis")
        super().__init__(name, config)

    def n_pods(self) -> int:
        return int(self.declared_topology()["pod"])
