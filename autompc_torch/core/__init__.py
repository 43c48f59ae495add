from .system import System
from .task import Task
from .trajectory import TimeStep, Trajectory, TrajectoryBatch, batch
