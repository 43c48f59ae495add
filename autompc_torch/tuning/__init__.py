from .bo import BatchBayesOpt, RandomForestSurrogate
from .pipeline_tuner import PipelineTuner, PipelineTuneResult
