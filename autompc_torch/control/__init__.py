from .controller import Controller, ControllerFactory
from .ilqr import (
    IterativeLQR,
    IterativeLQRFactory,
    make_batched_ilqr_solver,
    make_ilqr_solver,
    make_scheduled_ilqr_solver,
    parse_schedule,
)
from .receding import make_receding_ilqr_loop
