"""Rule registry. Each rule module registers its Rule subclass here; the
engine instantiates every registered rule per run. Order is the report
order for same-line findings, so keep it sorted by rule id."""

from .determinism import WallClockInScoringPath  # noqa: E402
from .hostsync import HostSyncInJitKernel  # noqa: E402
from .swallow import SilentExceptionSwallow  # noqa: E402
from .planfreeze import PlanMutationAfterSubmit  # noqa: E402
from .lockfields import LockDiscipline  # noqa: E402
from .spans import SpanCoverage  # noqa: E402
from .mergedsubmit import MergedSubmitDiscipline  # noqa: E402
from .wallclock import BareWallClockInBrokerServer  # noqa: E402
from .blocking import BlockingWithoutTimeout  # noqa: E402
from .laneowner import LaneOwnerDiscipline  # noqa: E402
from .accumulation import UnboundedAccumulation  # noqa: E402
from .admissiongate import AdmissionGateDiscipline  # noqa: E402
from .algorithmseam import AlgorithmSeamDiscipline  # noqa: E402
from .scoredump import ScoreDumpDiscipline  # noqa: E402
from .shardingseam import ShardingSeamDiscipline  # noqa: E402
from .solverseam import SolverSeamDiscipline  # noqa: E402
from .kernelseam import KernelSeamDiscipline  # noqa: E402
from .provenance import ConstantProvenanceDiscipline  # noqa: E402
from .scorestate import ScoreStateDiscipline  # noqa: E402
from .topologyseam import TopologySeamDiscipline  # noqa: E402
from .migrationseam import MigrationSeamDiscipline  # noqa: E402

REGISTRY = [
    WallClockInScoringPath,  # NTA001
    HostSyncInJitKernel,  # NTA002
    SilentExceptionSwallow,  # NTA003
    PlanMutationAfterSubmit,  # NTA004
    LockDiscipline,  # NTA005
    SpanCoverage,  # NTA006
    MergedSubmitDiscipline,  # NTA007
    BareWallClockInBrokerServer,  # NTA008
    BlockingWithoutTimeout,  # NTA009
    LaneOwnerDiscipline,  # NTA010
    UnboundedAccumulation,  # NTA011
    AdmissionGateDiscipline,  # NTA012
    AlgorithmSeamDiscipline,  # NTA013
    ScoreDumpDiscipline,  # NTA014
    ShardingSeamDiscipline,  # NTA015
    SolverSeamDiscipline,  # NTA016
    KernelSeamDiscipline,  # NTA017
    ConstantProvenanceDiscipline,  # NTA018
    ScoreStateDiscipline,  # NTA019
    TopologySeamDiscipline,  # NTA020
    MigrationSeamDiscipline,  # NTA021
]

__all__ = ["REGISTRY"]
