from .checkpoint import CheckpointManager  # noqa: F401
from .elastic import (  # noqa: F401
    ElasticConfig, ElasticController, ReplanReport, fingerprint_digest,
    remap_flat, remap_zero_state, reshard_tree, survivor_mesh)
from .faults import (  # noqa: F401
    FaultEvent, FaultInjector, FaultPlan, TransientTransferError)
from .guard import (  # noqa: F401
    CollectiveGuard, GuardConfig, GuardEvent, LinkHealth,
    PersistentCommFailure, digest_agreement, payload_checksum,
    schedule_digest)
from .health import NaNWatchdog, StragglerMonitor, WatchdogConfig  # noqa: F401
