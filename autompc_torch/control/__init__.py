from .controller import Controller, ControllerFactory
from .lqr import LQR, LQRFactory, FiniteHorizonLQR, InfiniteHorizonLQR
from .zero import ZeroController, ZeroControllerFactory
from .ilqr import (
    IterativeLQR,
    IterativeLQRFactory,
    make_batched_ilqr_solver,
    make_ilqr_solver,
    make_scheduled_ilqr_solver,
    make_staged_ilqr_solver,
    parse_schedule,
)
from .mppi import MPPI, MPPIFactory
from .nmpc import DirectTranscriptionController, DirectTranscriptionControllerFactory
from .receding import make_receding_ilqr_loop, make_receding_mppi_loop, make_receding_sqp_loop
