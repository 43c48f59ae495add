"""Count the PyTorch operations of one MPC step of the MPPI and
direct-transcription paths of ``chip_smoke.py`` phase 14, on the CPU.

Every operation that is not a view is one kernel launch (or more) on the
card: the count is the launch count a step makes before any of it is
fused. The shapes are phase 14's (the cartpole SINDy model of phase 2,
fitted here on a smaller draw: the count does not depend on the fit), so
the count is the one the card's run makes.

Run:
    python tools/torch_controller_ops.py
"""

import os
import sys
from collections import Counter

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class CountOps(TorchDispatchMode):
    """Counts the dispatched operations that are not views (nor
    ``_unsafe_view``, a reshape that launches nothing)."""

    def __init__(self):
        super().__init__()
        self.ops = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if not func.is_view and func.overloadpacket is not torch.ops.aten._unsafe_view:
            self.ops[str(func.overloadpacket)] += 1
        return func(*args, **(kwargs or {}))


def count(fn):
    with CountOps() as c:
        fn()
    return sum(c.ops.values()), c.ops


def main():
    import chip_smoke as cs
    from autompc_torch.benchmarks import CartpoleSwingupBenchmark
    from autompc_torch.control import MPPI, DirectTranscriptionController
    from autompc_torch.core.trajectory import zeros as traj_zeros
    from autompc_torch.costs import QuadCost
    from autompc_torch.parallel import DirectTranscriptionFanout, MPPIFanout
    from autompc_torch.sysid import SINDy

    torch.set_num_threads(4)
    cpu = torch.device("cpu")
    bench = CartpoleSwingupBenchmark()
    system = bench.system
    model = SINDy(system, device="cpu", **cs.SINDY_KW)
    model.train(bench.gen_trajs_batch(seed=42, n_trajs=20, traj_len=50, device="cpu"))
    qd = np.diag([10.0, 0.1, 0.01, 0.01])
    task = bench.task.copy()
    task.set_cost(QuadCost(system, qd, 0.001 * np.eye(1), qd, goal=np.zeros(4)))
    obs = torch.as_tensor(task.get_init_obs())
    rows = []

    def controller_step(con):
        cstate = con.traj_to_state(traj_zeros(system, 1, device=cpu))
        con.run(cstate, obs)                                   # warm (lazy set-up)
        return count(lambda: con.run(cstate, obs))

    rows.append(("MPPI step (H=20, 4,096 paths)", controller_step(
        MPPI(system, task, model, horizon=cs.CT_H, num_path=cs.CT_PATHS, sigma=cs.CT_SIGMA,
             lmda=cs.CT_LMDA))))
    rows.append(("DT step (20 knots, 10 SQP iterations)", controller_step(
        DirectTranscriptionController(system, task, model, horizon=cs.DT_HORIZON_S))))

    batch = {k: v for k, v in cs.fanout_candidates(cpu, cs.CF_B, cs.CF_SEED).items()}
    rng = np.random.default_rng(cs.CF_SEED + 1)
    batch.update(sigma=torch.as_tensor(rng.uniform(0.1, 2, cs.CF_B)),
                 lmda=torch.as_tensor(rng.uniform(0.1, 2, cs.CF_B)))
    for name, fan in (
            (f"MPPIFanout, 2 MPC steps (B={cs.CF_B}, H={cs.CF_H}, {cs.CF_PATHS} paths)",
             MPPIFanout(system, bench.task, model, model, horizon=cs.CF_H, num_path=cs.CF_PATHS,
                        n_steps=2, goal=np.zeros(4), device="cpu")),
            (f"DirectTranscriptionFanout, 2 MPC steps (B={cs.CF_B}, {cs.CF_KNOTS} knots)",
             DirectTranscriptionFanout(system, bench.task, model, model,
                                       horizon_knots=cs.CF_KNOTS, n_steps=2, goal=np.zeros(4),
                                       device="cpu"))):
        fan(batch)
        rows.append((name, count(lambda: fan(batch))))
    for name, (n, ops) in rows:
        print(f"{name}: {n} operations; most: {ops.most_common(6)}", flush=True)


if __name__ == "__main__":
    main()
