from .profiling import timeit_distinct
