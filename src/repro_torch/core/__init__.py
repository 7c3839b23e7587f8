"""The StreamFlow engine of the PyTorch/CUDA port: the paper's contribution
as a composable layer.

Workflow (DAG + POSIX step ids) x declarative multi-site environments
(Connector implementations) wired by a StreamFlow file, executed by a
locality-aware FCFS scheduler with R1-R4 semantics (atomic deployment
units, task->service bindings, two-step baseline transfers, elision).

The modules are the JAX package's engine (``repro/core``) under the same
names, pure Python, with one design change: the ``mesh`` connector runs a
site's steps on a CUDA device (its config's ``device``; the GPU unless it
says ``cpu``) and hands the step ``ctx["device"]`` where the reference
hands a JAX mesh.  A dict document loads without PyYAML.  The plan-time
analyzer (``analyzer.py``: the SF3xx proofs and the static cost report)
and the multi-tenant TES-style service (``service.py``: submit, status,
cancel, fair share and deployment pooling) are the reference's too.

``__all__`` is the JAX package's, name for name.
"""
from repro_torch.core.workflow import (Workflow, Step, Requirements, Port, Token,
                                 Invocation, InvocationPlan, match_binding,
                                 token_ref, parse_token_ref, invocation_base)
from repro_torch.core.connector import (Connector, ConnectorCopyKind, ObjectStore,
                                  content_digest, serialize, deserialize)
from repro_torch.core.connectors import (LocalConnector, MeshConnector,
                                   MultiPodConnector, SimClusterConnector,
                                   make_connector)
from repro_torch.core.deployment import (DeploymentManager, DeploymentPlane,
                                   ModelSpec, replica_base)
from repro_torch.core.autoscale import (AutoscaleConfig, AutoscalePolicy,
                                  Autoscaler)
from repro_torch.core.scheduler import (Scheduler, SchedulerSnapshot, Policy,
                                  DataLocalityPolicy,
                                  RoundRobinPolicy, LoadBalancePolicy,
                                  BackfillPolicy, LocalityBatchPolicy,
                                  WidestFirstPolicy, ScatterSpreadPolicy,
                                  JobDescription, JobAllocation,
                                  ResourceAllocation, JobStatus, POLICIES)
from repro_torch.core.datamanager import (DataManager, DataRef, RoutePlan,
                                    TransferRecord)
from repro_torch.core.topology import (LinkSpec, MANAGEMENT, Route,
                                 TopologyGraph)
from repro_torch.core.streamflow_file import (load as load_streamflow_file,
                                        StreamFlowConfig, Binding,
                                        StreamFlowFileError, validate)
from repro_torch.core.checker import (CODES as CHECKER_CODES, Diagnostic,
                                WorkflowCheckError, dry_run)
from repro_torch.core.frontend import (ToolInput, ToolSpec, compile_declarative,
                                 parse_tools)
from repro_torch.core.executor import StreamFlowExecutor, RunResult, JobEvent
from repro_torch.core.fault import FaultConfig, DurationTracker
from repro_torch.core.persistence import (CacheConfig, CheckpointConfig,
                                    ExecutionJournal, InvocationCache,
                                    JournalError, JournalState,
                                    invocation_memo_key)
from repro_torch.core.events import (EventSink, EventStream, RunCancelled,
                               WorkflowEvent, WorkflowStarted,
                               InvocationStateChanged, TokenAvailable,
                               TransferRouted, WorkflowCompleted,
                               WorkflowFailed, WorkflowCancelled,
                               TERMINAL_EVENTS)
from repro_torch.core.service import (WorkflowService, ServiceConfig,
                                      TenantPolicy, DeploymentPool,
                                      PooledDeploymentManager, Run, RunInfo,
                                      ServiceError, UnknownRunError, QUEUED,
                                      RUNNING, COMPLETE, EXECUTOR_ERROR,
                                      CANCELED, TERMINAL_STATES)
from repro_torch.core.connectors import (start_external_site, get_external_site,
                                   stop_external_site)

__all__ = [
    # workflow / dataflow model
    "Workflow", "Step", "Requirements", "Port", "Token",
    "Invocation", "InvocationPlan", "match_binding",
    "token_ref", "parse_token_ref", "invocation_base",
    # connectors + stores
    "Connector", "ConnectorCopyKind", "ObjectStore", "content_digest",
    "serialize", "deserialize",
    "LocalConnector", "MeshConnector", "MultiPodConnector",
    "SimClusterConnector", "make_connector",
    "start_external_site", "get_external_site", "stop_external_site",
    # deployment + autoscaling
    "DeploymentManager", "DeploymentPlane", "ModelSpec", "replica_base",
    "AutoscaleConfig", "AutoscalePolicy", "Autoscaler",
    # scheduling
    "Scheduler", "SchedulerSnapshot",
    "Policy", "DataLocalityPolicy", "RoundRobinPolicy",
    "LoadBalancePolicy", "BackfillPolicy", "LocalityBatchPolicy",
    "WidestFirstPolicy", "ScatterSpreadPolicy", "JobDescription",
    "JobAllocation", "ResourceAllocation", "JobStatus", "POLICIES",
    # data plane
    "DataManager", "DataRef", "RoutePlan", "TransferRecord",
    "LinkSpec", "MANAGEMENT", "Route", "TopologyGraph",
    # config loading
    "load_streamflow_file", "StreamFlowConfig", "Binding",
    "StreamFlowFileError", "validate",
    # declarative frontend + static checker
    "CHECKER_CODES", "Diagnostic", "WorkflowCheckError", "dry_run",
    "ToolInput", "ToolSpec", "compile_declarative", "parse_tools",
    # execution
    "StreamFlowExecutor", "RunResult", "JobEvent",
    "FaultConfig", "DurationTracker",
    # persistence: journal + cross-run cache
    "CacheConfig", "CheckpointConfig", "ExecutionJournal",
    "InvocationCache", "JournalError", "JournalState",
    "invocation_memo_key",
    # events
    "EventSink", "EventStream", "RunCancelled", "WorkflowEvent",
    "WorkflowStarted", "InvocationStateChanged", "TokenAvailable",
    "TransferRouted", "WorkflowCompleted", "WorkflowFailed",
    "WorkflowCancelled", "TERMINAL_EVENTS",
    # service
    "WorkflowService", "ServiceConfig", "TenantPolicy", "DeploymentPool",
    "PooledDeploymentManager", "Run", "RunInfo", "ServiceError",
    "UnknownRunError", "QUEUED", "RUNNING", "COMPLETE", "EXECUTOR_ERROR",
    "CANCELED", "TERMINAL_STATES",
]
