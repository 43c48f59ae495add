from .benchmark import Benchmark
from .cartpole import CartpoleSwingupBenchmark, CartpoleSwingupV2Benchmark
from .halfcheetah import HalfcheetahBenchmark
from .pendulum import PendulumSwingupBenchmark
