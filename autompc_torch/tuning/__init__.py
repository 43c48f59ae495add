from .bo import BatchBayesOpt, RandomForestSurrogate
from .model_tuner import ModelTuner, ModelTuneResult
from .pipeline_tuner import PipelineTuner, PipelineTuneResult
