from .benchmark import Benchmark
from .cartpole import CartpoleSwingupBenchmark
from .halfcheetah import HalfcheetahBenchmark
