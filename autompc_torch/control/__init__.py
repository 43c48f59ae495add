from .ilqr import (
    make_batched_ilqr_solver,
    make_scheduled_ilqr_solver,
    parse_schedule,
)
from .receding import make_receding_ilqr_loop
