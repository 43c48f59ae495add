from .profiling import timeit_distinct
from .simulation import simulate
