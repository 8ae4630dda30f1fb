# Copied from ray_tpu/autoscaler/v2/instance.py (JAX-free): module names read ray_tpu_torch.
"""Instance lifecycle state machine.

Reference: python/ray/autoscaler/v2/instance_manager/common.py
(InstanceUtil.get_valid_transitions) — every autoscaled cloud instance
moves through an explicit status graph; transitions outside the table
are bugs, every transition is recorded with a timestamp so stuck
states can be timed out.

Status graph (happy path left-to-right):

  QUEUED -> REQUESTED -> ALLOCATED -> RAY_RUNNING -> RAY_STOP_REQUESTED
                                                    -> RAY_STOPPING
                                                    -> RAY_STOPPED
                                                    -> TERMINATING
                                                    -> TERMINATED

with failure edges REQUESTED->{QUEUED retry, ALLOCATION_FAILED},
ALLOCATED->RAY_INSTALLING->{RAY_RUNNING, RAY_INSTALL_FAILED}, and
TERMINATING->TERMINATION_FAILED->TERMINATING retry.
"""

from __future__ import annotations

import enum
import time
import uuid
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set


class InstanceStatus(enum.Enum):
    #: Scheduler decided a new instance is needed; not yet requested.
    QUEUED = "QUEUED"
    #: Launch request sent to the cloud provider.
    REQUESTED = "REQUESTED"
    #: Cloud instance appears in the provider's non-terminated list.
    ALLOCATED = "ALLOCATED"
    #: Framework daemon being installed/booted on the instance.
    RAY_INSTALLING = "RAY_INSTALLING"
    #: Node daemon registered with the head and is schedulable.
    RAY_RUNNING = "RAY_RUNNING"
    #: Autoscaler wants the daemon stopped (idle scale-down).
    RAY_STOP_REQUESTED = "RAY_STOP_REQUESTED"
    #: Daemon draining.
    RAY_STOPPING = "RAY_STOPPING"
    #: Daemon reported dead by the head.
    RAY_STOPPED = "RAY_STOPPED"
    #: Terminate request sent to the cloud provider.
    TERMINATING = "TERMINATING"
    #: Gone from the provider's non-terminated list. Terminal.
    TERMINATED = "TERMINATED"
    #: Provider could not allocate (or timed out repeatedly). Terminal.
    ALLOCATION_FAILED = "ALLOCATION_FAILED"
    #: Daemon failed to boot on an allocated instance. Terminal-ish
    #: (reconciler terminates the cloud instance).
    RAY_INSTALL_FAILED = "RAY_INSTALL_FAILED"
    #: Provider terminate call failed; retried.
    TERMINATION_FAILED = "TERMINATION_FAILED"


S = InstanceStatus

#: Valid transitions (reference: common.py get_valid_transitions).
VALID_TRANSITIONS: Dict[InstanceStatus, Set[InstanceStatus]] = {
    S.QUEUED: {S.REQUESTED},
    S.REQUESTED: {S.ALLOCATED, S.QUEUED, S.ALLOCATION_FAILED},
    S.ALLOCATED: {
        S.RAY_INSTALLING,
        S.RAY_RUNNING,
        S.RAY_STOPPING,
        S.RAY_STOPPED,
        S.TERMINATING,
        S.TERMINATED,
    },
    S.RAY_INSTALLING: {
        S.RAY_RUNNING,
        S.RAY_INSTALL_FAILED,
        S.RAY_STOPPED,
        S.TERMINATING,
        S.TERMINATED,
    },
    S.RAY_RUNNING: {
        S.RAY_STOP_REQUESTED,
        S.RAY_STOPPING,
        S.RAY_STOPPED,
        S.TERMINATING,
        S.TERMINATED,
    },
    S.RAY_STOP_REQUESTED: {
        S.RAY_STOPPING,
        S.RAY_STOPPED,
        S.RAY_RUNNING,  # stop request rejected (node busy again)
        S.TERMINATED,
    },
    S.RAY_STOPPING: {S.RAY_STOPPED, S.TERMINATING, S.TERMINATED},
    S.RAY_STOPPED: {S.TERMINATING, S.TERMINATED},
    S.TERMINATING: {S.TERMINATED, S.TERMINATION_FAILED},
    S.TERMINATION_FAILED: {S.TERMINATING},
    S.TERMINATED: set(),
    S.ALLOCATION_FAILED: set(),
    S.RAY_INSTALL_FAILED: {S.TERMINATING, S.TERMINATED},
}

#: Statuses that count toward a node type's live/launching population
#: (for max_workers accounting and demand netting).
ACTIVE_STATUSES = {
    S.QUEUED,
    S.REQUESTED,
    S.ALLOCATED,
    S.RAY_INSTALLING,
    S.RAY_RUNNING,
}


@dataclass
class StatusTransition:
    status: InstanceStatus
    timestamp: float
    details: str = ""


@dataclass
class Instance:
    instance_type: str
    instance_id: str = field(
        default_factory=lambda: uuid.uuid4().hex[:12]
    )
    status: InstanceStatus = S.QUEUED
    #: Provider-side id once ALLOCATED (opaque; one per instance).
    cloud_instance_id: Optional[str] = None
    #: Cluster node ids of the daemons on this instance once
    #: RAY_RUNNING (a TPU slice instance hosts several daemons).
    node_ids: List[str] = field(default_factory=list)
    launch_attempts: int = 0
    #: Ephemeral bookkeeping (not a state-machine field): last time
    #: the reconciler saw any of this instance's daemons busy.
    last_busy: float = 0.0
    history: List[StatusTransition] = field(default_factory=list)

    def __post_init__(self):
        if not self.history:
            self.history.append(
                StatusTransition(self.status, time.time(), "created")
            )

    def transition(
        self, new_status: InstanceStatus, details: str = ""
    ) -> bool:
        """Apply a transition; False (no mutation) if invalid."""
        if new_status not in VALID_TRANSITIONS[self.status]:
            return False
        self.status = new_status
        self.history.append(
            StatusTransition(new_status, time.time(), details)
        )
        return True

    def seconds_in_status(self) -> float:
        return time.time() - self.history[-1].timestamp

    def is_active(self) -> bool:
        return self.status in ACTIVE_STATUSES

    def summary(self) -> dict:
        return {
            "instance_id": self.instance_id,
            "instance_type": self.instance_type,
            "status": self.status.value,
            "cloud_instance_id": self.cloud_instance_id,
            "node_ids": list(self.node_ids),
            "transitions": [
                {
                    "status": t.status.value,
                    "at": t.timestamp,
                    "details": t.details,
                }
                for t in self.history
            ],
        }
