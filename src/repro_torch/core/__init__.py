"""Protocol layer: task assignment, attacks, aggregators, compression, the
round and the trainer. The package exports the reference's names
(``repro.core``): the six protocol submodules, the round, the trainer and
the scenario grid."""
from repro_torch.core import aggregators, attacks, coding, compression, task_matrix, theory
from repro_torch.core.byzantine import ProtocolConfig, protocol_round
from repro_torch.core.engine import TrajectoryResult, protocol_rounds, run_trajectory
from repro_torch.core.participation import ParticipationSpec
from repro_torch.core.scenarios import Scenario, grid_finals, participation_sweep, run_grid, run_scenario, section7_grid

__all__ = [
    "aggregators",
    "attacks",
    "coding",
    "compression",
    "task_matrix",
    "theory",
    "ProtocolConfig",
    "ParticipationSpec",
    "protocol_round",
    "participation_sweep",
    "TrajectoryResult",
    "protocol_rounds",
    "run_trajectory",
    "Scenario",
    "grid_finals",
    "run_grid",
    "run_scenario",
    "section7_grid",
]
