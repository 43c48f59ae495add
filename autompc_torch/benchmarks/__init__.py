from .benchmark import Benchmark
from .cartpole import CartpoleSwingupBenchmark
